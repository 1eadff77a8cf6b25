"""The port's span recorder (`llamagen_tpu_torch/utils/profiling.py`) and
the spans of the serving loop and the training step, on the CPU: off, it
stores nothing; on, spans nest by thread with their counts, on the clock
of `torch.profiler`'s events; a tiny engine records one `engine.decode`
per decode step and one `engine.admit` per admission group; a tiny
training step one forward, backward and update; `trace` writes the spans
into its Chrome trace; the engine's first-token time is observed in the
admission's own cycle."""

import json
import threading
import time

import pytest
import torch

from llamagen_tpu_torch.config import VQConfig, gpt_config
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.models.vq import VQModel
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
from llamagen_tpu_torch.train import c2i, t2i
from llamagen_tpu_torch.utils import profiling

C2I = gpt_config("GPT-nano", block_size=16, cls_token_num=1, vocab_size=64,
                 num_classes=10)
T2I = gpt_config("GPT-nano", block_size=16, cls_token_num=8, vocab_size=64,
                 model_type="t2i", caption_dim=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def by_name(recorded, name):
    return [s for s in recorded if s.name == name]


def self_ns(recorded, i):
    s = recorded[i]
    return (s.end_ns - s.start_ns) - sum(
        c.end_ns - c.start_ns for c in recorded if c.parent == i)


def test_off_stores_nothing_and_returns_the_shared_noop():
    profiling.disable()
    with profiling.tracing():
        pass
    first = profiling.span("a", rows=2)
    assert first is profiling.NOOP and profiling.span("b") is first
    with profiling.span("a", rows=2) as sp:
        sp.count(done=1)
    assert profiling.spans() == []


def test_nesting_parents_counts_and_self_times():
    seen = {}

    def worker():
        with profiling.span("thread"):
            seen["inner"] = len(profiling.RECORDER._stack())

    with profiling.tracing():
        with profiling.span("outer", pairs=3) as outer:
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
            outer.count(done=2)
        with profiling.span("after"):
            pass
    assert not t.is_alive() and seen["inner"] == 1
    rec = profiling.spans()
    assert [s.name for s in rec] == ["outer", "inner", "thread", "after"]
    assert [s.parent for s in rec] == [None, 0, None, None]
    assert rec[0].counts == {"pairs": 3, "done": 2}
    assert all(s.start_ns <= s.end_ns for s in rec)
    assert rec[0].start_ns <= rec[1].start_ns <= rec[1].end_ns \
        <= rec[0].end_ns
    assert self_ns(rec, 0) >= 2e6 and self_ns(rec, 1) >= 4e6
    assert self_ns(rec, 0) < (rec[0].end_ns - rec[0].start_ns) - 4e6
    # the epoch clock: within a second of time.time_ns()
    assert abs(rec[-1].end_ns - time.time_ns()) < 1e9
    with profiling.tracing():  # enabling again starts an empty store
        pass
    assert profiling.spans() == []


def test_spans_lie_on_the_profilers_clock():
    """An aten::mm run inside a span lies inside it once the span is put
    on the profile's timeline (trace_start_ns() is the events' zero)."""
    a = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            with profiling.span("mm"):
                time.sleep(0.001)
                a @ a
                time.sleep(0.001)
    start = prof.profiler.kineto_results.trace_start_ns()
    (sp,) = profiling.spans()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    lo, hi = (sp.start_ns - start) / 1e3, (sp.end_ns - start) / 1e3
    assert lo <= mm.time_range.start < mm.time_range.end <= hi


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    a = torch.randn(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.span("mm", rows=256):
            time.sleep(0.001)
            a @ a
            time.sleep(0.001)
    assert not profiling.RECORDER.on
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    (sp,) = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert sp["name"] == "mm" and sp["args"] == {"rows": 256}
    (mm,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"]
    assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] \
        + sp["dur"]


def engine(cfg, pairs=2, chunk=4, max_new=8):
    model = gpt.init_weights(gpt.Transformer(cfg), seed=0).eval()
    return ServeEngine(model, num_pairs=pairs, max_new_tokens=max_new,
                       chunk=chunk, compute_dtype=torch.float32,
                       sampling_params=SamplingParams(cfg_scale=2.0))


def submit(eng, n):
    if not eng.t2i:
        return [eng.submit(i % 10) for i in range(n)]
    g = torch.Generator().manual_seed(0)
    t = eng.cfg.cls_token_num
    out = []
    for i in range(n):
        mask = torch.arange(t) >= i % t
        cap = torch.randn(t, eng.cfg.caption_dim, generator=g) * mask[:, None]
        out.append(eng.submit_caption(cap, mask))
    return out


@pytest.mark.parametrize("cfg", [C2I, T2I], ids=["c2i", "t2i"])
def test_engine_spans(cfg):
    """3 requests on 2 slots (t2i: 10 on 9, admitted in groups of 8): one
    `engine.decode` per decode step, one `engine.admit` per admission
    group, with their parents and counts."""
    pairs, n = (2, 3) if cfg is C2I else (9, 10)
    eng = engine(cfg, pairs=pairs)
    submit(eng, n)
    groups = []
    admit = eng._admit_grouped

    def counted(taken, install):
        groups.extend(range(0, len(taken), eng._abatch))
        admit(taken, install)

    eng._admit_grouped = counted
    with profiling.tracing():
        eng.run_until_idle()
    rec = profiling.spans()
    names = [s.name for s in rec]
    cycles = by_name(rec, "engine.admit_and_step")
    decodes = by_name(rec, "engine.decode")
    assert len(decodes) == eng.steps_run > 0
    assert sum(s.counts["steps"] for s in cycles) == eng.steps_run
    # a CPU engine runs every step eagerly: none is a graph replay
    assert all(s.counts == {"rows": 2 * pairs, "graphed": 0}
               for s in decodes)
    admits = by_name(rec, "engine.admit")
    assert sum(s.counts["pairs"] for s in admits) == n
    if cfg is T2I:
        assert len(admits) == eng.admissions == len(groups) == 3
    else:  # one group a cycle that admitted: both slots, then the third
        assert len(admits) == 2 and eng.admissions == 0
    for s in decodes + admits:
        assert names[s.parent] == "engine.admit_and_step"
    harvests = by_name(rec, "engine.harvest")
    reads = by_name(rec, "engine.harvest.read")
    assert len(harvests) == len(cycles)
    assert sum(s.counts["done"] for s in harvests) == n
    assert len(reads) == sum(s.counts["done"] > 0 for s in harvests)
    assert all(names[s.parent] == "engine.harvest" for s in reads)
    assert {"engine.admit_and_step", "engine.harvest"} >= {
        s.name for s in rec if s.parent is None}


@pytest.mark.parametrize("cfg", [C2I, T2I], ids=["c2i", "t2i"])
def test_first_token_is_observed_in_the_admission_cycle(cfg):
    eng = engine(cfg)
    reqs = submit(eng, 3)
    while eng.pending.qsize() or any(r is not None
                                     for r in eng.slot_request):
        eng._admit_and_step()
        for r in reqs:  # every admitted request has its first token
            assert (r.admitted_at is None) == (r.first_token_at is None)
        eng._harvest()
    for r in reqs:
        assert r.submitted_at <= r.admitted_at <= r.first_token_at \
            <= r.finished_at
    st = eng.stats()
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    assert st["ttft_p50_s"] == pytest.approx(ttft[1])


def vq_model():
    cfg = VQConfig(codebook_size=64, codebook_embed_dim=8, z_channels=32,
                   ch=32, num_res_blocks=1)
    return VQModel(cfg, encoder=True).eval()


@pytest.mark.parametrize("kind", ["c2i", "t2i"])
def test_train_step_spans(kind):
    b = 2
    g = torch.Generator().manual_seed(0)
    kw = dict(compute_dtype=torch.float32, remat=False)
    if kind == "c2i":
        state, step = c2i.build_trainer(C2I, torch.device("cpu"), **kw)
        batch = c2i.Batch(labels=torch.tensor([1, 2]),
                          tokens=torch.randint(0, 64, (b, 16), generator=g))
    else:
        state, step = t2i.build_trainer(T2I, vq_model(), torch.device("cpu"),
                                        **kw)
        batch = t2i.T2IBatch(
            images=torch.rand(b, 64, 64, 3, generator=g) * 2 - 1,
            captions=torch.randn(b, 8, 16, generator=g),
            emb_masks=torch.ones(b, 8, dtype=torch.int32))
    step(state, batch, 0)
    with profiling.tracing():
        step(state, batch, 0)
    rec = profiling.spans()
    assert [s.name for s in rec] == ["train.forward", "train.backward",
                                     "train.update"]
    assert rec[0].counts == {"samples": b}
    assert all(s.parent is None for s in rec)
    assert rec[0].end_ns <= rec[1].start_ns and rec[1].end_ns \
        <= rec[2].start_ns
