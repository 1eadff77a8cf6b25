"""Host milliseconds per training step in the program's `train.backward`
spans: `value.backward()`, where the thread blocks while autograd
launches the backward, over the traced steps."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "train")
    if rec is None:
        return None
    return _program.total_us(rec, "train.backward") / 1e3 \
        / trace.facts["steps"]
