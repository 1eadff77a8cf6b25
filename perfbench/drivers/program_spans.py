"""A driver that runs another (the mix's `inner`: `serve` or `train`) with
the program's span recorder (`llamagen_tpu_torch/utils/profiling.py`) on
inside the profiled span of a `--trace 1` run and off everywhere else:
the `--trace 0` run and the untraced cycles and steps of a traced run
record nothing.

The recorded spans go into the trace's facts on its timeline:
`facts["trace_start_ns"]` is the profile's `trace_start_ns()` (epoch ns,
the zero of every device operation's time), and
`facts["program_spans"]` the spans as (name, start us, end us, parent
index, counts) from it. The recorder puts its spans on that epoch clock
itself, so no marker kernel is needed. A program without the recorder
runs as under the inner driver and leaves both keys out.

The inner driver calls `harness.profile` and the profile's reduction
`harness._reduce` through the harness module; for the inner run both are
wrapped, and put back after it.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

from perfbench import harness


@contextlib.contextmanager
def _recorded_in_profile() -> Iterator[None]:
    from llamagen_tpu_torch.utils import profiling
    if not hasattr(profiling, "tracing"):
        yield
        return
    profile, reduce = harness.profile, harness._reduce

    def traced_profile(fn, spans):
        def inside():
            with profiling.tracing():
                return fn()
        return profile(inside, spans)

    def placed_reduce(prof, order, window_s):
        trace = reduce(prof, order, window_s)
        start = prof.profiler.kineto_results.trace_start_ns()
        trace.facts["trace_start_ns"] = start
        trace.facts["program_spans"] = [
            (s.name, (s.start_ns - start) / 1e3, (s.end_ns - start) / 1e3,
             s.parent, s.counts) for s in profiling.spans()]
        return trace

    harness.profile, harness._reduce = traced_profile, placed_reduce
    try:
        yield
    finally:
        harness.profile, harness._reduce = profile, reduce


def run(r: harness.Run) -> harness.Outcome:
    inner = importlib.import_module(
        f"perfbench.drivers.{r.traffic['inner']}")
    if not r.trace:
        return inner.run(r)
    with _recorded_in_profile():
        return inner.run(r)
