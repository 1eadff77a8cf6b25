"""Host milliseconds per training step in the program's `train.forward`
spans: the loss's forward (`train/c2i.py::make_train_step`'s `loss(...)`
call, t2i's VQ encode inside it), over the traced steps."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "train")
    if rec is None:
        return None
    return _program.total_us(rec, "train.forward") / 1e3 \
        / trace.facts["steps"]
