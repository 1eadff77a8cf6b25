"""Profiling hooks: `torch.profiler` traces and a measured memory report
(PyTorch port of `llamagen_tpu/utils/profiling.py`).

JAX traces with `jax.profiler.trace` and reads its memory breakdown from
the compiler before anything runs (`compiled.memory_analysis()`). PyTorch
has no compiled program to ask: `memory_analysis` runs the function once
and reports what the caching allocator saw, under JAX's key names, so
`format_memory` prints either. `trace` exports a Chrome trace (chrome://
tracing, Perfetto) of the CPU and, on a card, CUDA activity, with the
program's own spans beside them.

The span recorder names what the host does between the device's
operations: `span(name, **counts)` around a stretch of host work records
(name, start, end, parent, counts) while the recorder is on (`tracing()`,
or `enable()` / `disable()`), and stores nothing while it is off, which it
is by default. Times are `time.perf_counter_ns()` moved by one offset,
taken when the recorder is enabled, onto `time.time_ns()`'s epoch clock:
the clock of `torch.profiler`'s `trace_start_ns()`, from which its host
and device events are offsets, so a span and the kernels it launched sit
on one timeline without a marker kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

TRACE_FILE = "trace.json"


class Span(NamedTuple):
    """One recorded span: epoch nanoseconds (end None while it is open),
    the index in `spans()` of the innermost span open on the same thread
    when it began (None at the top), and the counts given at its start."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    counts: Dict[str, int]


class _Off:
    """The span of a recorder that is off: it records nothing."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, **counts: int) -> None:
        return None


class _Open:
    """A span being recorded: [name, start, end, parent record, counts],
    on its thread's stack of open spans while it is open."""
    __slots__ = ("recorder", "record", "stack")

    def __init__(self, recorder: "Recorder", name: str,
                 counts: Dict[str, int]):
        self.recorder = recorder
        self.record = [name, 0, None, None, counts]

    def __enter__(self) -> "_Open":
        self.stack = stack = self.recorder._stack()
        self.record[3] = stack[-1] if stack else None
        stack.append(self.record)
        self.recorder._records.append(self.record)
        self.record[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.record[2] = time.perf_counter_ns()
        self.stack.pop()

    def count(self, **counts: int) -> None:
        """Counts known only inside the span."""
        self.record[4].update(counts)


NOOP = _Off()  # what `span` returns while the recorder is off


class Recorder:
    """The span store: off until `enable()`, which clears it and takes the
    clock offset; `disable()` stops recording and keeps what was
    recorded for `spans()`."""

    def __init__(self):
        self.on = False
        self._offset_ns = 0
        self._records: List[list] = []
        self._local = threading.local()

    def _stack(self) -> List[list]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enable(self) -> None:
        self._records = []
        self._local = threading.local()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def spans(self) -> List[Span]:
        index = {id(r): i for i, r in enumerate(self._records)}
        off = self._offset_ns
        return [Span(name, start + off, None if end is None else end + off,
                     None if parent is None else index[id(parent)], counts)
                for name, start, end, parent, counts in self._records]


RECORDER = Recorder()


def span(name: str, **counts: int):
    """A context manager that records the block as a span named `name`
    with `counts` (integers known at its start; its `count(**counts)` adds
    those known only inside) while the recorder is on; while it is off,
    the one shared no-op `NOOP`."""
    if not RECORDER.on:
        return NOOP
    return _Open(RECORDER, name, counts)


def enable() -> None:
    """Turn the recorder on, with an empty store and a fresh clock offset."""
    RECORDER.enable()


def disable() -> None:
    """Turn the recorder off; what it recorded stays for `spans()`."""
    RECORDER.disable()


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """The recorder on for the block (and off after it)."""
    RECORDER.enable()
    try:
        yield
    finally:
        RECORDER.disable()


def spans() -> List[Span]:
    """The spans of the last time the recorder was on, in start order, on
    the epoch clock."""
    return RECORDER.spans()


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Append `recorded` to the Chrome trace at `path` as complete events
    of their own process row, on the trace's clock (its `ts` are
    microseconds after `baseTimeNanoseconds`)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    for s in recorded:
        if s.end_ns is None:
            continue
        doc["traceEvents"].append({
            "ph": "X", "name": s.name, "cat": "program_span",
            "pid": "llamagen_tpu_torch spans", "tid": 0,
            "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.counts})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into `log_dir`/trace.json (CPU activity, and CUDA
    activity where a card is present) with the span recorder on, and
    write its spans into the trace on the same clock; a no-op for None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with tracing():
            yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _add_spans(path, spans())


def _tensors(obj: Any, seen: set) -> Iterator[torch.Tensor]:
    """Every tensor reachable from `obj` through modules, optimizers,
    containers, dataclasses and NamedTuples, each object once."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            yield from _tensors(state, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():  # e.g. a wrapper holding an optimizer
            if isinstance(v, (torch.Tensor, nn.Module, torch.optim.Optimizer,
                              dict, list, tuple)):
                yield from _tensors(v, seen)


def _storages(*objs: Any) -> Dict[Any, int]:
    """{storage: bytes} of the distinct storages reachable from `objs`."""
    storages = {}
    seen: set = set()
    for obj in objs:
        for t in _tensors(obj, seen):
            if isinstance(t, DTensor):  # FSDP2's shards: this rank's
                t = t.to_local()
            st = t.untyped_storage()
            storages[(t.device, st.data_ptr())] = st.nbytes()
    return storages


def memory_report(fn, *args, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run `fn(*args, **kwargs)` once: (its result, the report). The report
    has JAX's keys: argument and output bytes (distinct storages), the
    peak bytes the call held beyond what was allocated when it began
    (`temp_size_in_bytes`: CUDA's allocator peak after a reset; None, not
    measured, on the CPU), 0 for generated code, the output's bytes that
    are the arguments' own storages (`alias_size_in_bytes`: a step that
    updates its state in place returns it), and `total_bytes` their sum,
    as JAX sums its fields."""
    cuda = torch.cuda.is_available() and any(
        t.is_cuda for t in _tensors((args, kwargs), set()))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    temp = None
    if cuda:
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before
    arg, res = _storages(args, kwargs), _storages(out)
    report = {"argument_size_in_bytes": sum(arg.values()),
              "output_size_in_bytes": sum(res.values()),
              "temp_size_in_bytes": temp,
              "generated_code_size_in_bytes": 0,
              "alias_size_in_bytes": sum(v for k, v in res.items()
                                         if k in arg)}
    report["total_bytes"] = sum(v for v in report.values() if v)
    return out, report


def memory_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """The report of `memory_report` (the call runs once)."""
    return memory_report(fn, *args, **kwargs)[1]


def format_memory(report: Dict[str, Any]) -> str:
    if not report:
        return "memory analysis unavailable"
    gb = 1024 ** 3
    parts = [f"{k.replace('_size_in_bytes', '')}="
             + ("not measured" if v is None else f"{v / gb:.3f}GiB")
             for k, v in report.items() if k != "total_bytes"]
    return (f"device memory: total {report['total_bytes'] / gb:.3f}GiB "
            f"({', '.join(parts)})")
