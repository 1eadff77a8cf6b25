"""Host milliseconds per t2i admission group (at most 8 pairs) in the
program's `engine.admit` spans (`serve/engine.py::EngineBase.
_admit_grouped`: the packing, the copies, `make_admit_batch`'s prefill
and `scatter_pairs` launched), over the traced cycle's groups."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    n = _program.count(rec, "engine.admit") if rec else 0
    if n == 0 or not trace.facts.get("admissions"):
        return None
    return _program.total_us(rec, "engine.admit") / 1e3 / n
