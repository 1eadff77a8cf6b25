"""K7 (`csrc/int8_matmul.cu`'s `moe_int8_kernel`, the grouped W8A16 expert
product) against its bound: for every routed layer of every traced decode
step, the larger of its bytes (every expert's int8 matrices and scales,
the pairs' activations) over 3.35 TB/s and its 2 * pairs * 3 * D * F
operations over 989 TFLOP/s (`counts/mla_moe.py::k7_step_bound_s`),
divided by the device time of the kernels whose names hold "moe_int8",
in %."""

from perfbench.counts import mla_moe
from perfbench.metrics import _mla_moe


def read(trace):
    f = _mla_moe.facts(trace)
    if f is None:
        return None
    k7_s = trace.device_s(*_mla_moe.K7)
    if k7_s <= 0:
        return None
    rows = 2 * len(f["pads"])
    return 100.0 * f["n_steps"] * mla_moe.k7_step_bound_s(f["config"], rows) \
        / k7_s
