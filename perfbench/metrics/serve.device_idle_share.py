"""Share of the traced cycle with no device operation running (the union
of the operations' intervals), in %."""


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve" or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
