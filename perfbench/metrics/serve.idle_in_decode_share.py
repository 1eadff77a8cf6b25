"""Share of the traced cycle in which the device ran no operation while
the host was inside the program's `engine.decode` spans (launching a
decode step), in %: beside `serve.device_idle_share`, on its base."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    if rec is None:
        return None
    return 100.0 * _program.idle_within_s(trace, rec, "engine.decode") \
        / trace.window_s
