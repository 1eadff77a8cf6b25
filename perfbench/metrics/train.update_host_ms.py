"""Host milliseconds per training step in the program's `train.update`
spans: the clip and AdamW of `optimizer.step`, and `ema_update`, over
the traced steps."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "train")
    if rec is None:
        return None
    return _program.total_us(rec, "train.update") / 1e3 \
        / trace.facts["steps"]
