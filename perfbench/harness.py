"""What every cell shares: the cell's files found by name, the check that
no JAX module is loaded, the device record, the profiled span and its
reduction to kernel times, idle gaps and the breakdown, and the result line.

Nothing here imports the program (`llamagen_tpu_torch`); the drivers do.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# compared whole against the top-level name of every loaded module: the
# port's `llamagen_tpu_torch` begins with the JAX package's name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "llamagen_tpu")


def forbidden_modules() -> List[str]:
    """The loaded top-level modules that are JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One entry of `workloads` with its configuration and traffic files."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def find_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell called `name`, with the files its entries name."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}: "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, w["chips"], load_json(ROOT / conf["file"]),
                load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def metric_reader(name: str) -> Callable[["Trace"], Optional[float]]:
    """`read` of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Spans and the profiled span
# ---------------------------------------------------------------------------


class Spans:
    """Host spans named by the harness around its calls into the program.
    Each span's host seconds are summed by name. Inside a profiled span
    each span instead starts and ends with a marker kernel (in launch
    order in `order`), so that the device timeline says which span's work
    each device operation was and which span the device waited on."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.order: Optional[List[Tuple[str, bool]]] = None

    def reset(self) -> None:
        self.seconds.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        if self.order is not None:
            self._mark(name, True)
            yield
            self._mark(name, False)
            return
        t0 = time.perf_counter()
        yield
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0

    def _mark(self, name: str, opening: bool) -> None:
        if torch.cuda.is_available():
            torch.cuda._sleep(0)
            self.order.append((name, opening))


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


@dataclass
class Trace:
    """A profiled span reduced to what the per-layer readers take:
    device operations (name, start us, end us) in execution order, the
    harness's spans on the device timeline (name, start us, end us: from
    the end of the span's opening marker to the start of its closing one),
    the span's length on the host clock, and the cell's own facts for the
    counts (`facts`)."""
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window_s: float
    facts: Dict[str, Any] = field(default_factory=dict)

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        total, end = 0.0, -math.inf
        for s, e in sorted((s, e) for _, s, e in self.ops):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e6

    def device_s(self, *needles: str, within: Optional[str] = None) -> float:
        """Seconds of the operations whose lower-cased name holds one of
        `needles` (all with none), optionally only those inside an
        instance of the span `within`."""
        ops = self.ops
        if within:
            inside = [(s, e) for n, s, e in self.spans if n == within]
            ops = [o for o in ops
                   if any(s <= o[1] and o[2] <= e for s, e in inside)]
        return sum(e - s for n, s, e in ops
                   if not needles or any(k in n.lower() for k in needles)) \
            / 1e6

    def idle_gaps(self) -> Dict[str, float]:
        """Seconds of device idle time between operations, each gap put
        down to the innermost span the next operation belongs to: the
        device waited for that span's launches ("host_outside_any_span"
        where it belongs to none)."""
        out: Dict[str, float] = {}
        end = None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                owner, width = "host_outside_any_span", math.inf
                for n, a, b in self.spans:
                    if a <= s <= b and b - a < width:
                        owner, width = n, b - a
                out[owner] = out.get(owner, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        return out

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}


def profile(fn: Callable[[], Any], spans: Spans
            ) -> Tuple[Any, Callable[[], Trace]]:
    """Run fn() under torch.profiler, device activity only (recording
    every host operation would slow the host loop that paces serving),
    the harness's spans marked on the device timeline; the span opens and
    closes with a device sync. Returns fn's result and a function that
    reduces the profile to a `Trace`: call it after the window, since
    reading the profiler's events takes seconds of host time."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans.order = []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            window_s = time.perf_counter() - t0
        order = spans.order
    finally:
        spans.order = None
    return out, lambda: _reduce(prof, order, window_s)


def _reduce(prof, order: List[Tuple[str, bool]], window_s: float) -> Trace:
    ops, marks = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # the profiler mirrors host annotations on the device timeline
        if e.name.startswith(("Optimizer.", "ProfilerStep")):
            continue
        item = (e.name, e.time_range.start, e.time_range.end)
        (marks if MARKER in e.name else ops).append(item)
    ops.sort(key=lambda o: o[1])
    marks.sort(key=lambda o: o[1])
    device_spans, open_ = [], []
    if len(marks) == len(order):
        for (name, opening), (_, s, e) in zip(order, marks):
            if opening:
                open_.append((name, e))
            else:
                _, a = open_.pop()
                device_spans.append((name, a, s))
    return Trace(ops, device_spans, window_s)


# ---------------------------------------------------------------------------
# The run's record
# ---------------------------------------------------------------------------


def device_record(dev: torch.device, count: int) -> Dict[str, Any]:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def free_device(dev: torch.device) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


@dataclass
class Run:
    """One run of a cell: what the command line gave, the process's start
    on the host clock, and (tests and calibration only) config overrides,
    a hook that plants faults in the program's objects, and extra
    readings to take after the check."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    shrink: Dict[str, Any] = field(default_factory=dict)
    plant: Callable[[str, Any], Any] = lambda kind, obj: obj
    extra: Tuple[str, ...] = ()

    @property
    def config(self) -> Dict[str, Any]:
        return {**self.cell.config, **self.shrink}

    @property
    def traffic(self) -> Dict[str, Any]:
        return {**self.cell.traffic, **self.shrink.get("traffic", {})}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Outcome:
    """What a driver hands back: the attempted and failed units, the
    end-to-end metrics (--trace 0) or the trace (--trace 1), the device
    record, and the numbers compared with their limits."""
    attempted: int
    failed: int
    metrics: Dict[str, float]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    trace: Optional[Trace] = None
    readings: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(c["limit"] is not None and math.isfinite(c["value"])
                   and c["value"] <= c["limit"]
                   for c in self.checks.values()) and self.failed == 0


def result_line(cell: Cell, out: Outcome, trace: bool) -> Dict[str, Any]:
    """The result object: the cell's end-to-end metrics, or its per-layer
    metrics read from the trace (a reader that finds nothing is left
    out), and the compared numbers last."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict[str, Any]] = {}
    device = dict(out.device)
    res: Dict[str, Any] = {"correct": out.correct,
                           "attempted": out.attempted, "failed": out.failed}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
    else:
        for m in cell.end_to_end:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                      "unit": units[m["name"]]}
    res["metrics"] = metrics
    res["device"] = device
    if trace:
        res["breakdown"] = out.trace.breakdown()
    res["checks"] = out.checks
    return res
