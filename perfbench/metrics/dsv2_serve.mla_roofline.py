"""K6 (`csrc/mla_decode.cu`, the absorbed latent decode attention) against
its bound: the bytes the traced cycle's decode steps need in every layer
(`counts/mla_moe.py::k6_bytes`: the latent rows below each row's
position, 1,152 bytes each at DeepSeek-V2's widths, the new row, q and
out) over 3.35 TB/s, divided by the device time of the kernels whose
names hold "mla_decode", in %."""

from perfbench import counts
from perfbench.counts import mla_moe
from perfbench.metrics import _mla_moe, _serve


def read(trace):
    f = _mla_moe.facts(trace)
    if f is None:
        return None
    k6_s = trace.device_s(*_mla_moe.K6)
    if k6_s <= 0:
        return None
    c = f["config"]
    nbytes = sum(mla_moe.k6_bytes(pos, c)
                 for pos, _ in _serve.decode_steps(trace))
    return 100.0 * c["num_hidden_layers"] * nbytes \
        / counts.PEAK_BYTES_PER_S / k6_s
