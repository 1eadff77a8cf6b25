"""Device milliseconds per t2i admission (`serve/engine.py::
make_admit_batch` + `scatter_pairs`, at most 8 pairs): the device time
of every operation inside the harness's admission spans (marked on
the device timeline) in the traced cycle, over the admissions."""


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve":
        return None
    n = len(trace.facts.get("admissions", []))
    s = trace.device_s(within="admission")
    if n == 0 or s <= 0:
        return None
    return 1e3 * s / n
