"""Share of the traced steps' device operation time in operations that
are neither matrix products (cuBLAS, cuDNN convolutions), K4 nor the
optimizer and EMA: the eager elementwise passes, reductions, copies and
the loss of `models/gpt.py::forward_train`, in %."""

from perfbench.metrics import _groups


def read(trace):
    if trace is None or trace.facts.get("driver") != "train" or not trace.ops:
        return None
    by = {}
    for n, s, e in trace.ops:
        g = _groups.group(n)
        by[g] = by.get(g, 0.0) + (e - s)
    total = sum(v for g, v in by.items() if g != "marker")
    return 100.0 * by.get("other", 0.0) / total if total > 0 else None
