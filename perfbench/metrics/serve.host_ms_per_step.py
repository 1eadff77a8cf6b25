"""Host milliseconds per decode step: the harness's span around the
engine's `_admit_and_step` (admission and the launches of a chunk, no
device read), summed over the window's untraced cycles, over the decode
steps they ran."""


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve":
        return None
    return trace.facts["host_ms_per_step"]
