"""Share of the traced cycle in which the device ran no operation while
the host was inside the program's `engine.admit` spans (a t2i admission
group), in %: beside `serve.device_idle_share`, on its base."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    if rec is None or not trace.facts.get("admissions"):
        return None
    return 100.0 * _program.idle_within_s(trace, rec, "engine.admit") \
        / trace.window_s
