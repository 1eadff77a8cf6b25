"""Host milliseconds per decode step of the MLA + MoE serving driver: the
harness's span around the engine's `_admit_and_step` (admission and the
replays of a chunk, no device read), summed over the window's untraced
cycles, over the decode steps they ran."""

from perfbench.metrics import _mla_moe


def read(trace):
    f = _mla_moe.facts(trace)
    return None if f is None else f.get("host_ms_per_step")
