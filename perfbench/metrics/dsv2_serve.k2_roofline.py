"""K2 (`csrc/int8_matmul.cu`'s `int8_mma_kernel`) at the MLA + MoE model's
dense shapes against its bound: for each of a decode step's K2 matmuls at
2P rows (`counts/mla_moe.py::k2_matmuls`: q_proj, kv_a_proj_with_mqa,
o_proj, the dense and shared SwiGLUs, the head) the larger of its bytes
over 3.35 TB/s and its 2MKN operations over 989 TFLOP/s, summed over the
traced steps, divided by the device time of the kernels whose names hold
"int8_mma" or "int8_matmul", in %."""

from perfbench.counts import mla_moe
from perfbench.metrics import _mla_moe


def read(trace):
    f = _mla_moe.facts(trace)
    if f is None:
        return None
    k2_s = trace.device_s(*_mla_moe.K2)
    if k2_s <= 0:
        return None
    rows = 2 * len(f["pads"])
    return 100.0 * f["n_steps"] * mla_moe.k2_step_bound_s(f["config"], rows) \
        / k2_s
