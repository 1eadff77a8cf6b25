"""Device milliseconds per step of the frozen VQ encode inside the t2i
step (`models/vq.py::encode`): the device time of every operation
inside the harness's spans around each encode call (marked on the
device timeline),
over the traced steps."""


def read(trace):
    if trace is None or trace.facts.get("driver") != "train":
        return None
    s = trace.device_s(within="vq_encode")
    if s <= 0:
        return None
    return 1e3 * s / trace.facts["steps"]
