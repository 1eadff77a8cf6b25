"""Model FLOPs of the traced cycle (`counts/mla_moe.py::decode_step_flops`
for every decode step: 2 per active weight per row, CFG rows counted, and
the latent attention at each row's position in every layer) over the
cycle's length, over 989 TFLOP/s, in %."""

from perfbench import counts
from perfbench.counts import mla_moe
from perfbench.metrics import _mla_moe, _serve


def read(trace):
    f = _mla_moe.facts(trace)
    if f is None or not trace.ops:
        return None
    flops = sum(mla_moe.decode_step_flops(f["config"], pos)
                for pos, _ in _serve.decode_steps(trace))
    return 100.0 * flops / trace.window_s / counts.PEAK_BF16_FLOPS
