"""What the readers of the program's own spans share. The `program_spans`
driver puts the spans that `llamagen_tpu_torch/utils/profiling.py`
recorded inside the profiled span into `facts["program_spans"]`, as
(name, start us, end us, parent index, counts) on the trace's timeline;
a program without the recorder leaves the key out, and every reader then
finds nothing."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def spans(trace, driver: str) -> Optional[list]:
    """The program's spans of a trace of `driver`'s (None where there are
    none to read)."""
    if trace is None or trace.facts.get("driver") != driver:
        return None
    return trace.facts.get("program_spans") or None


def total_us(recorded, *names: str) -> float:
    """Summed length of the spans named `names`."""
    return sum(e - s for n, s, e, _, _ in recorded if n in names)


def count(recorded, name: str) -> int:
    return sum(1 for r in recorded if r[0] == name)


def self_us(recorded, *names: str) -> float:
    """Summed length of the spans named `names`, less that of their
    children."""
    own = {i for i, r in enumerate(recorded) if r[0] in names}
    return total_us(recorded, *names) - sum(
        e - s for _, s, e, p, _ in recorded if p in own)


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_within_s(trace, recorded, *names: str) -> float:
    """Seconds in which the host was inside a span named `names` and no
    device operation ran: the spans' union less its overlap with the
    union of the operations' intervals."""
    inside = _union([(s, e) for n, s, e, _, _ in recorded if n in names])
    busy = _union([(s, e) for _, s, e in trace.ops])
    idle, j = 0.0, 0
    for a, b in inside:
        idle += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            idle -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return idle / 1e6
