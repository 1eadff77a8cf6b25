"""Host milliseconds per decode step in the program's `engine.decode`
spans (`serve/engine.py::make_engine_step`: a step's embeddings,
`decode_step_slots` and `sample_and_advance` launched), over the traced
cycle's decode steps."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    if rec is None:
        return None
    return _program.total_us(rec, "engine.decode") / 1e3 \
        / trace.facts["n_steps"]
