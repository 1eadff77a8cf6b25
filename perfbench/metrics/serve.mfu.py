"""Model FLOPs of the traced cycle (`counts.decode_step_flops` for every
decode step, CFG rows counted and attention at each row's position;
`counts.prefill_flops` for each t2i admission) over the cycle's length,
over 989 TFLOP/s, in %."""

from perfbench import counts
from perfbench.metrics import _serve


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve" or not trace.ops:
        return None
    c = trace.facts["config"]
    flops = sum(counts.decode_step_flops(c, pos, pads)
                for pos, pads in _serve.decode_steps(trace))
    flops += sum(counts.prefill_flops(c, list(a) * 2)
                 for a in trace.facts["admissions"])
    return 100.0 * flops / trace.window_s / counts.PEAK_BF16_FLOPS
