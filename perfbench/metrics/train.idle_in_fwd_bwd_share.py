"""Share of the traced steps in which the device ran no operation while
the host was inside the program's `train.forward` or `train.backward`
spans (launching them), in %: beside `train.device_idle_share`, on its
base."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "train")
    if rec is None:
        return None
    return 100.0 * _program.idle_within_s(
        trace, rec, "train.forward", "train.backward") / trace.window_s
