"""Share of the traced cycle with no device operation running (the union
of the operations' intervals), in %."""

from perfbench.metrics import _mla_moe


def read(trace):
    if _mla_moe.facts(trace) is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
