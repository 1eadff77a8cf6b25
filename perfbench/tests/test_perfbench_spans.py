"""The readers of the program's own spans (`metrics/_program.py`, the ten
readers that use it, and `spans_probe.py`'s split of the idle time) on
synthetic traces with known values; every earlier reader reads the same
with and without the program's spans in the facts; the `program_spans`
driver turns the recorder on only inside the profiled span, and at the
tiny size on the CPU every reader finds a finite number in each cell it
is meant for; on the card, a span around a kernel followed by a sync
contains the kernel's device interval."""

import json
import math

import pytest
import torch

from perfbench import harness
from perfbench.drivers import program_spans
from perfbench.tests.tiny import tiny_run

SERVE_NEW = ["serve.decode_launch_ms", "serve.loop_self_ms",
             "serve.harvest_wait_ms", "serve.idle_in_decode_share"]
T2I_NEW = ["t2i_serve.admit_host_ms", "t2i_serve.idle_in_admit_share"]
TRAIN_NEW = ["train.forward_host_ms", "train.backward_host_ms",
             "train.update_host_ms", "train.idle_in_fwd_bwd_share"]
NEW = SERVE_NEW + T2I_NEW + TRAIN_NEW
# device busy (us): [0, 100], [150, 400], [600, 700]
OPS = [("k", 0.0, 100.0), ("k", 150.0, 300.0), ("k", 250.0, 400.0),
       ("k", 600.0, 700.0)]
SERVE_SPANS = [("engine.admit_and_step", 0.0, 800.0, None, {"steps": 2}),
               ("engine.admit", 20.0, 120.0, 0, {"pairs": 8}),
               ("engine.decode", 120.0, 200.0, 0, {"rows": 16}),
               ("engine.decode", 450.0, 650.0, 0, {"rows": 16}),
               ("engine.harvest", 800.0, 1000.0, None, {"done": 1}),
               ("engine.harvest.read", 850.0, 990.0, 4, {})]
TRAIN_SPANS = [("train.forward", 0.0, 160.0, None, {"samples": 4}),
               ("train.backward", 160.0, 500.0, None, {}),
               ("train.update", 500.0, 700.0, None, {})]


def config(name):
    return json.loads((harness.BENCH_DIR / "configs" / name).read_text())


def serve_trace(with_spans=True):
    facts = dict(config=config("gpt-xl-t2i-256.json"), driver="serve",
                 pos_end=torch.full((8,), 130).numpy(), n_steps=2,
                 pads=torch.zeros(8, dtype=torch.long).numpy(),
                 admissions=[[0] * 8], host_ms_per_step=3.0)
    if with_spans:
        facts.update(trace_start_ns=10 ** 18, program_spans=SERVE_SPANS)
    return harness.Trace(list(OPS), [("step", 0.0, 800.0)], 0.002, facts)


def train_trace(with_spans=True):
    facts = dict(config=config("gpt-l-c2i-384.json"), driver="train",
                 steps=1, batch=32)
    if with_spans:
        facts.update(trace_start_ns=10 ** 18, program_spans=TRAIN_SPANS)
    return harness.Trace(list(OPS), [("vq_encode", 0.0, 120.0)], 0.002,
                         facts)


@pytest.mark.parametrize("name,want", [
    ("serve.decode_launch_ms", (80 + 200) / 1e3 / 2),
    # (800 - 100 - 80 - 200) + (200 - 140) us of the loop's own
    ("serve.loop_self_ms", (420 + 60) / 1e3 / 2),
    ("serve.harvest_wait_ms", 140 / 1e3 / 2),
    # idle [120, 150] and [450, 600] of the decode spans
    ("serve.idle_in_decode_share", 100 * 180e-6 / 0.002),
    ("t2i_serve.admit_host_ms", 0.1),
    ("t2i_serve.idle_in_admit_share", 100 * 20e-6 / 0.002),
    ("train.forward_host_ms", 0.16),
    ("train.backward_host_ms", 0.34),
    ("train.update_host_ms", 0.2),
    # idle [100, 150] in the forward, [400, 500] in the backward
    ("train.idle_in_fwd_bwd_share", 100 * 150e-6 / 0.002),
])
def test_new_readers_on_a_synthetic_trace(name, want):
    read = harness.metric_reader(name)
    mine, other = (train_trace, serve_trace) if name.startswith("train.") \
        else (serve_trace, train_trace)
    assert read(mine()) == pytest.approx(want)
    assert read(mine(with_spans=False)) is None  # a program without spans
    assert read(other()) is None and read(None) is None


def test_overlapping_spans_count_their_idle_once():
    trace = train_trace()
    trace.facts["program_spans"] = [
        ("train.forward", 0.0, 160.0, None, {}),
        ("train.backward", 120.0, 500.0, None, {})]
    assert harness.metric_reader("train.idle_in_fwd_bwd_share")(trace) \
        == pytest.approx(100 * 150e-6 / 0.002)


def test_the_probe_splits_the_idle_by_span():
    from perfbench import spans_probe
    got = spans_probe.by_span(serve_trace())
    assert got["engine.decode"] == pytest.approx(
        {"count": 2, "host_ms": 0.28, "self_ms": 0.28, "idle_ms": 0.18})
    assert got["engine.admit_and_step"]["self_ms"] == pytest.approx(0.42)
    # 1,550 us idle in the 2,000 us window, 550 of them inside [0, 1000]
    assert got["idle_outside_ms"] == pytest.approx(1.0)


def test_earlier_readers_read_the_same_with_program_spans():
    names = sorted(p.stem for p in (harness.BENCH_DIR / "metrics").glob(
        "*.py") if not p.stem.startswith("_") and p.stem not in NEW)
    assert "serve.host_ms_per_step" in names and len(names) == 11
    for make in (serve_trace, train_trace):
        for name in names:
            read = harness.metric_reader(name)
            assert read(make(False)) == read(make(True)), name


class Counted:
    """`profiling.tracing` counted, with whether a profile was running each
    time it was entered."""

    def __init__(self, monkeypatch):
        from llamagen_tpu_torch.utils import profiling
        self.in_profile = []
        tracing = profiling.tracing

        def counted():
            self.in_profile.append(torch._C._autograd._profiler_enabled())
            return tracing()

        monkeypatch.setattr(profiling, "tracing", counted)


@pytest.mark.parametrize("workload,inner,names", [
    ("t2i-xl256-serve-capacity", "serve", SERVE_NEW + T2I_NEW),
    ("c2i-l384-serve-capacity", "serve", SERVE_NEW),
    ("c2i-l384-train", "train", TRAIN_NEW),
    ("t2i-xl256-train", "train", TRAIN_NEW)])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_driver_traces_the_profiled_span_only(workload, inner, names,
                                                  trace, monkeypatch):
    """At the tiny size on the CPU, each cell with its mix's driver put
    under `program_spans`: off in a `--trace 0` run; in a `--trace 1` run
    on exactly once, inside the profiled span, and every reader meant for
    the cell reads a finite number."""
    counted = Counted(monkeypatch)
    r = tiny_run(workload, trace=bool(trace),
                 bench="perfbench/tests/_bench_all.json")
    r.cell.traffic = dict(r.cell.traffic, driver="program_spans",
                          inner=inner)
    wrapped = harness.profile, harness._reduce
    out = program_spans.run(r)
    assert out.correct, out.checks
    assert (harness.profile, harness._reduce) == wrapped  # put back
    assert counted.in_profile == [True] * trace
    if trace:
        facts = out.trace.facts
        assert facts["trace_start_ns"] > 0 and facts["program_spans"]
        for name in names:
            v = harness.metric_reader(name)(out.trace)
            assert v is not None and math.isfinite(v) and v >= 0, name
    else:
        assert out.trace is None


def test_the_checked_t2i_mix_is_the_mix_with_a_limit():
    """`t2i-offline-512pairs-checked` is `t2i-offline-512pairs`' traffic
    under the `program_spans` driver, with the calibrated greedy gap."""
    mix = harness.BENCH_DIR / "traffic"
    checked = json.loads((mix / "t2i-offline-512pairs-checked.json")
                         .read_text())
    plain = json.loads((mix / "t2i-offline-512pairs.json").read_text())
    assert (checked.pop("driver"), checked.pop("inner")) \
        == ("program_spans", plain.pop("driver"))
    assert checked.pop("limits") == {"greedy_gap": 2.0}
    plain.pop("limits")
    assert checked == plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's clock")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_around_a_synced_kernel_contains_it(cuda):
    """Five spans, each around one spin kernel and a sync, placed on the
    profile's timeline: each contains its kernel. Prints the offsets
    (us from the span's start to the kernel's, and from the kernel's end
    to the span's)."""
    from llamagen_tpu_torch.utils import profiling

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.tracing():
            for _ in range(5):
                with profiling.span("spin"):
                    torch.cuda._sleep(1_000_000)
                    torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "spin_kernel" in e.name)
    spans = profiling.spans()
    assert len(kernels) == len(spans) == 5
    offsets = []
    for s, (a, b) in zip(spans, kernels):
        lo, hi = (s.start_ns - start) / 1e3, (s.end_ns - start) / 1e3
        offsets.append((round(a - lo, 1), round(hi - b, 1)))
    print("span-to-kernel offsets (us, start / end):", offsets)
    assert all(x > 0 and y > 0 for x, y in offsets), offsets
