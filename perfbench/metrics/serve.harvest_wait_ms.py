"""Host milliseconds per decode step in the harvest's one device read
(the program's `engine.harvest.read` span around `tokens_out.cpu()`,
which waits for every step launched), over the traced cycle's decode
steps. A rise beside a fall of `serve.decode_launch_ms` means the card
now paces the loop."""

from perfbench.metrics import _program


def read(trace):
    rec = _program.spans(trace, "serve")
    if rec is None:
        return None
    return _program.total_us(rec, "engine.harvest.read") / 1e3 \
        / trace.facts["n_steps"]
