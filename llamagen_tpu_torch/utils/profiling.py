"""Profiling hooks: `torch.profiler` traces and a measured memory report
(PyTorch port of `llamagen_tpu/utils/profiling.py`).

JAX traces with `jax.profiler.trace` and reads its memory breakdown from
the compiler before anything runs (`compiled.memory_analysis()`). PyTorch
has no compiled program to ask: `memory_analysis` runs the function once
and reports what the caching allocator saw, under JAX's key names, so
`format_memory` prints either. `trace` exports a Chrome trace (chrome://
tracing, Perfetto) of the CPU and, on a card, CUDA activity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into `log_dir`/trace.json (CPU activity, and CUDA
    activity where a card is present); a no-op for None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
