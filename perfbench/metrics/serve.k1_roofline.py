"""K1 (`csrc/decode_attention.cu`, the int8-cache entry of
`attn_mma_kernel`) against its bound: the bytes the traced cycle's decode
steps need in every layer (`counts.k1_bytes`: int8 rows and scales up
to each row's position, the exact tail, q, the new row, out, flushes)
over 3.35 TB/s, divided by the device time of the kernels whose names
hold "attn_mma" or "decode_attention", in %."""

from perfbench import counts
from perfbench.metrics import _serve


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve":
        return None
    k1_s = trace.device_s("attn_mma", "decode_attention")
    if k1_s <= 0:
        return None
    c = trace.facts["config"]
    nbytes = sum(counts.k1_bytes(pos, c["n_head"], c["n_kv_head"],
                                 c["head_dim"], pads)
                 for pos, pads in _serve.decode_steps(trace))
    return 100.0 * c["n_layer"] * nbytes / counts.PEAK_BYTES_PER_S / k1_s
