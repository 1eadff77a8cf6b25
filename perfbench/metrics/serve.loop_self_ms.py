"""Host milliseconds per decode step that the engine's loop spends in
itself: the program's `engine.admit_and_step` and `engine.harvest` spans
less their child spans (decode launches, admissions, the harvest's
read), over the traced cycle's decode steps."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    if rec is None:
        return None
    return _program.self_us(rec, "engine.admit_and_step", "engine.harvest") \
        / 1e3 / trace.facts["n_steps"]
