"""The serving engine's decode step as one CUDA graph
(`llamagen_tpu_torch/serve/engine.py::DecodeGraphs`).

CPU: `sample_and_advance` and `apply_admission` update the `EngineState`
in place, so that no tensor of the state changes its storage (a replay
reads and writes the addresses it was captured on), and give exactly
what the rebinding versions they replaced give (kept below), over
staggered admissions, with filters on and off and with penalties; the
engine keeps its state's storage over steps, admissions and slot reuse
(c2i and t2i); a CPU engine captures nothing and its greedy tokens equal
`generate`'s.

Card (`-m cuda`; no JAX here): on a small GPT with W8A16 layers and an
int8 cache, the graphed engine and an eager engine on the same model give
bit-identical greedy tokens (staggered admissions, filters off and on,
penalties, t2i with left pads) and equal launch counters; at temperature
1 the replays draw fresh noise from the generator as the eager steps do
(the same seed, the same tokens); the loop stays at most one chunk
ahead of the card; a TP shard stays eager; the replayed kernels appear
under their names in the profiler.
"""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.attention import decode_attention
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                 quantize_gpt_params)
from llamagen_tpu_torch.serve import engine as E
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine

C2I = GPTConfig(dim=128, n_layer=2, n_head=2, vocab_size=512,
                block_size=36)
T2I = GPTConfig(dim=128, n_layer=2, n_head=2, vocab_size=512,
                block_size=36, model_type="t2i", cls_token_num=40,
                caption_dim=48)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several pytest workers share the CPU: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captures and replays CUDA graphs")
    return torch.device("cuda")


# --- the rebinding versions the in-place helpers replaced -------------------


def _rebinding_sample_and_advance(state, logits, max_new_tokens,
                                  filters_off=False):
    ss = state.sp_slots
    mixed = sampling.cfg_mix(logits, ss.cfg_scale)
    counts = state.output_counts
    if counts is not None:
        mixed = sampling.apply_penalties(
            mixed, counts, presence=ss.presence, frequency=ss.frequency,
            repetition=ss.repetition)
    nxt = sampling.sample_per_slot(mixed, ss.temperature, ss.top_k,
                                   ss.top_p, state.generator, filters_off)
    going = state.active & (state.n_generated < max_new_tokens)
    cols = torch.arange(max_new_tokens, device=nxt.device)
    write = going[:, None] & (cols[None, :] == state.n_generated[:, None])
    state.tokens_out = torch.where(write, nxt[:, None], state.tokens_out)
    state.n_generated = state.n_generated + going.to(torch.int32)
    state.cur_token = torch.where(going, nxt, state.cur_token)
    state.pos = state.pos + state.active.to(torch.int32)
    state.active = state.active & (state.n_generated < max_new_tokens)
    if counts is not None:
        sampling.update_output_counts(counts, nxt, going)


def _rebinding_apply_admission(state, admit_mask, admit_labels, admit_sp):
    state.pos = torch.where(admit_mask, 0, state.pos)
    state.active = state.active | admit_mask
    state.labels = torch.where(admit_mask, admit_labels, state.labels)
    state.n_generated = torch.where(admit_mask, 0, state.n_generated)
    state.sp_slots = E.SlotSampling(*(
        torch.where(admit_mask, a.to(s.dtype), s)
        for a, s in zip(admit_sp, state.sp_slots)))
    if state.output_counts is not None:
        state.output_counts = torch.where(admit_mask[:, None], 0,
                                          state.output_counts)


def _tensors(state):
    """Every tensor of the state by name (the cache's per layer)."""
    c = state.cache
    out = {f: getattr(state, f) for f in ("pos", "active", "cur_token",
                                          "labels", "n_generated",
                                          "tokens_out", "output_counts",
                                          "prefix_pad")}
    out.update({f"sp.{f}": t for f, t in zip(E.SlotSampling._fields,
                                             state.sp_slots)})
    for name in ("kv", "kv_scale", "tail"):
        out.update({f"{name}{l}": t
                    for l, t in enumerate(getattr(c, name) or ())})
    return {k: t for k, t in out.items() if t is not None}


# slot admissions by step: slot 0 first, 1 and 2 two steps behind, 3 five
# behind; slots 0 and 1 are admitted again once they have finished
SCHEDULE = {0: [0], 2: [1, 2], 5: [3], 8: [0], 10: [1]}
MAX_NEW = 6


def _slot_params(slot, visit, filters_off, penalties):
    """Per-slot parameters: greedy and sampling slots side by side,
    top-k / top-p where the filters are on, penalties where asked."""
    sp = SamplingParams(cfg_scale=(1.0, 2.0, 4.0)[(slot + visit) % 3],
                        temperature=(0.0, 1.0, 0.7, 1.3)[slot])
    if not filters_off:
        sp.top_k = (0, 5, 0, 40)[slot]
        sp.top_p = (1.0, 1.0, 0.8, 0.9)[(slot + visit) % 4]
    if penalties:
        sp.repetition_penalty = (1.0, 1.3)[slot % 2]
        sp.frequency_penalty = (0.0, 0.1, 0.2, 0.0)[slot]
        sp.presence_penalty = (0.3, 0.0)[slot % 2]
    return sp


@pytest.mark.parametrize("penalties", [False, True],
                         ids=["plain", "penalties"])
@pytest.mark.parametrize("filters_off", [True, False],
                         ids=["filters-off", "filters-on"])
def test_in_place_helpers_equal_the_rebinding_ones(filters_off, penalties):
    """14 steps of 4 slots over random logits, the admissions of
    `SCHEDULE`: the in-place state equals the rebinding one after every
    admission and step, and no tensor of it changes its storage."""
    p = 4

    def fresh():
        return E.init_engine_state(
            C2I, p, MAX_NEW, torch.Generator().manual_seed(11), "cpu",
            cache_dtype=torch.float32, compute_dtype=torch.float32,
            track_counts=penalties)

    state, ref = fresh(), fresh()
    ptrs = {k: t.data_ptr() for k, t in _tensors(state).items()}
    rng = np.random.RandomState(3)
    visits = [0] * p
    for step in range(14):
        slots = SCHEDULE.get(step, [])
        if slots:
            mask = torch.zeros(p, dtype=torch.bool)
            mask[slots] = True
            labels = torch.tensor([rng.randint(1000) for _ in range(p)])
            rows = torch.zeros(len(E.SlotSampling._fields), p)
            for i in slots:
                rows[:, i] = torch.tensor(_slot_params(
                    i, visits[i], filters_off, penalties).row())
                visits[i] += 1
            sp = E.SlotSampling(*rows)
            E.apply_admission(state, mask, labels, sp)
            _rebinding_apply_admission(ref, mask, labels, sp)
        logits = torch.tensor(rng.randn(2 * p, C2I.vocab_size)
                              .astype(np.float32) * 2.0)
        E.sample_and_advance(state, logits, MAX_NEW, filters_off)
        _rebinding_sample_and_advance(ref, logits, MAX_NEW, filters_off)
        got, want = _tensors(state), _tensors(ref)
        assert list(got) == list(want)
        for k in got:
            assert torch.equal(got[k], want[k]), (step, k)
            assert got[k].data_ptr() == ptrs[k], (step, k)
    # every slot ran to the end at least once; the reused ones restarted
    assert int(state.n_generated.min()) >= 3
    assert (state.tokens_out != 0).any()


def _model(cfg, seed=0, head_std=0.5):
    model = gpt.init_weights(gpt.Transformer(cfg), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, head_std, generator=g)
    return model.eval()


def _captions(pads, cfg=T2I, seed=1):
    rng = np.random.RandomState(seed)
    emb = rng.randn(len(pads), cfg.cls_token_num,
                    cfg.caption_dim).astype(np.float32)
    mask = np.arange(cfg.cls_token_num)[None, :] >= np.asarray(pads)[:, None]
    emb[~mask] = 0.0
    return torch.tensor(emb), torch.tensor(mask)


@pytest.mark.parametrize("t2i", [False, True], ids=["c2i", "t2i"])
def test_engine_keeps_its_state_storage(t2i):
    """Over admissions (t2i: `scatter_pairs`), chunks and slot reuse, an
    engine's state keeps the storage a graph would be bound to."""
    cfg = T2I if t2i else C2I
    eng = ServeEngine(_model(cfg), num_pairs=2, max_new_tokens=12, chunk=4,
                      compute_dtype=torch.float32, cache_dtype=torch.int8,
                      track_penalties=True)
    before = E._addresses(eng.state)
    if t2i:
        caps, masks = _captions([0, 17, 33])
        out = eng.generate_t2i(caps, masks)
    else:
        out = eng.generate([3, 5, 7])
    assert out.shape == (3, 12) and eng.admissions == (2 if t2i else 0)
    assert E._addresses(eng.state) == before


@pytest.mark.parametrize("filters", ["off", "on"])
def test_cpu_engine_captures_nothing_and_matches_generate(filters):
    """A CPU engine runs every step eagerly (its graphed share reads 0) and
    its greedy tokens, staggered, equal `generate`'s (with the filters on,
    the sort runs in every step: top-k 5 keeps the argmax)."""
    model = _model(C2I)
    sp = SamplingParams(cfg_scale=2.0, temperature=0.0,
                        top_k=0 if filters == "off" else 5)
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=C2I.block_size,
                      chunk=4, compute_dtype=torch.float32,
                      sampling_params=sp)
    labels = [3, 7, 1, 9]
    reqs = [eng.submit(labels[0])]
    eng._admit_and_step()
    reqs += [eng.submit(l) for l in labels[1:]]
    eng.run_until_idle()
    ref = generate(model, torch.tensor(labels),
                   max_new_tokens=C2I.block_size, cfg_scale=2.0,
                   sample_logits=False, compute_dtype=torch.float32,
                   cache_dtype=torch.float32)
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                  ref.numpy())
    graphs = eng.step_fn.graphs
    assert not graphs.enabled and not graphs._graphs
    assert graphs.replays == 0 and graphs.eager == eng.steps_run
    assert eng.stats()["decode_graphed_share"] == 0.0
    eng.reset_stats()
    assert eng.stats()["decode_graphed_share"] is None


# --- on the card -----------------------------------------------------------

CARD_C2I = GPTConfig(dim=256, n_layer=2, n_head=4, vocab_size=4096,
                     block_size=64)
CARD_T2I = GPTConfig(dim=256, n_layer=2, n_head=4, vocab_size=4096,
                     block_size=64, model_type="t2i", cls_token_num=120,
                     caption_dim=64)


def _card_model(cfg, dev, seed=0, head_std=0.02, quantize_head=True):
    """W8A16 layers (and head) of a random GPT in bf16 on the card."""
    model = gpt.init_weights(gpt.Transformer(cfg, device=dev,
                                             dtype=torch.bfloat16), seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        model.output.weight.normal_(0.0, head_std, generator=g)
    return quantize_gpt_params(model.eval(), quantize_head=quantize_head)


def _card_run(model, graphed, sp, n_req=7, pairs=4, penalties=False,
              seed=5):
    """Requests through `pairs` slots, chunk 8: one alone, then the rest
    (staggered, slots reused); tokens, K1 / K2 launches and the engine.
    `graphed` False keeps the engine eager on the card."""
    cfg = model.cfg
    eng = ServeEngine(model, num_pairs=pairs, max_new_tokens=cfg.block_size,
                      chunk=8, seed=seed, compute_dtype=torch.bfloat16,
                      cache_dtype=torch.int8, sampling_params=sp,
                      track_penalties=penalties)
    eng._graphs.enabled = graphed
    k1, k2 = decode_attention.launches, int8_matmul.launches
    if cfg.model_type == "t2i":
        caps, masks = _captions([0, 60, 96, 119, 7, 33, 100][:n_req], cfg)
        submit = [lambda i=i: eng.submit_caption(caps[i], masks[i])
                  for i in range(n_req)]
    else:
        submit = [lambda i=i: eng.submit(i * 37 % 1000)
                  for i in range(n_req)]
    reqs = [submit[0]()]
    eng._admit_and_step()
    reqs += [s() for s in submit[1:]]
    eng.run_until_idle()
    torch.cuda.synchronize()
    return (np.stack([r.result for r in reqs]),
            (decode_attention.launches - k1, int8_matmul.launches - k2), eng)


CASES = {
    "filters-off": (CARD_C2I, SamplingParams(cfg_scale=2.0, temperature=0.0),
                    False),
    "filters-on": (CARD_C2I, SamplingParams(cfg_scale=4.0, temperature=0.0,
                                            top_k=20, top_p=0.9), False),
    "penalties": (CARD_C2I, SamplingParams(
        cfg_scale=2.0, temperature=0.0, repetition_penalty=1.3,
        frequency_penalty=0.1, presence_penalty=0.2), True),
    "t2i": (CARD_T2I, SamplingParams(cfg_scale=4.0, temperature=0.0),
            False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_engine_equals_eager_on_the_card(cuda, case):
    """Greedy tokens bit-identical and launch counters equal between the
    graphed and the eager engine on one W8A16 + int8-cache model; the
    graphed engine replays every step but each graph's first, and its
    share reads 1 after `reset_stats`."""
    cfg, sp, penalties = CASES[case]
    model = _card_model(cfg, cuda)
    eager, eager_n, e_eng = _card_run(model, False, sp, penalties=penalties)
    got, got_n, eng = _card_run(model, True, sp, penalties=penalties)
    np.testing.assert_array_equal(got, eager)
    assert got_n == eager_n
    t2i = cfg.model_type == "t2i"
    assert eager_n[0] == cfg.n_layer * e_eng.steps_run
    assert eager_n[1] == (5 * cfg.n_layer + 1) * e_eng.steps_run \
        + (5 * cfg.n_layer + 1) * e_eng.admissions * t2i
    graphs = eng._graphs
    assert list(graphs._graphs) == [sp.filters_off]
    assert graphs.eager == 1 and graphs.replays == eng.steps_run - 1
    assert e_eng.stats()["decode_graphed_share"] == 0.0
    eng.reset_stats()
    _ = [eng.submit_caption(*[x[0] for x in _captions([5], cfg)])
         if t2i else eng.submit(11)]
    eng.run_until_idle()
    assert eng.stats()["decode_graphed_share"] == 1.0


@pytest.mark.cuda
def test_replays_draw_fresh_noise_as_eager_steps_do(cuda):
    """A zero head makes every logit 0, so at temperature 1 each token is
    the argmax of the step's Gumbel noise alone: replays that reused their
    noise would repeat a slot's token; they do not, and the graphed engine
    draws exactly the eager engine's tokens from one seed, twice."""
    model = _card_model(CARD_C2I, cuda, head_std=0.0, quantize_head=False)
    sp = SamplingParams(cfg_scale=2.0, temperature=1.0)
    eager = _card_run(model, False, sp, seed=9)[0]
    first = _card_run(model, True, sp, seed=9)[0]
    again = _card_run(model, True, sp, seed=9)[0]
    other = _card_run(model, True, sp, seed=10)[0]
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, eager)
    assert (first != other).mean() > 0.9
    distinct = [len(set(row.tolist())) for row in first]
    assert min(distinct) > CARD_C2I.block_size // 2, distinct


@pytest.mark.cuda
def test_profiler_sees_the_replayed_kernels(cuda):
    """Under `torch.profiler` (device activity, started after the
    capture, as the benchmark's traced cycle is), a replayed chunk shows
    K1 and K2 under their names, one K1 a layer and 5 L + 1 K2 a step."""
    model = _card_model(CARD_C2I, cuda)
    eng = ServeEngine(model, num_pairs=4, max_new_tokens=64, chunk=8,
                      compute_dtype=torch.bfloat16, cache_dtype=torch.int8,
                      sampling_params=SamplingParams(temperature=0.0))
    for i in range(4):
        eng.submit(i)
    eng._admit_and_step()  # the eager step, the capture, the replays
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        before = eng._graphs.replays
        eng._admit_and_step()
        torch.cuda.synchronize()
    steps = eng._graphs.replays - before
    assert steps == 8
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    n = CARD_C2I.n_layer
    assert sum("attn_mma" in x for x in names) == n * steps, set(names)
    assert sum("int8_mma" in x for x in names) == (5 * n + 1) * steps


@pytest.mark.cuda
def test_host_stays_at_most_one_chunk_ahead(cuda):
    """Replays return at once, so the loop waits for its last chunk
    before it admits and launches the next: after a cycle with nothing
    to harvest, the chunk before it has run."""
    model = _card_model(CARD_C2I, cuda)
    eng = ServeEngine(model, num_pairs=4, max_new_tokens=64, chunk=8,
                      compute_dtype=torch.bfloat16, cache_dtype=torch.int8)
    eng.submit(1)
    eng._admit_and_step()  # eager step, capture, replays
    for _ in range(4):
        last = eng._chunk_end
        eng._admit_and_step()
        assert last.query()
        eng._harvest()  # nothing done: no read
    assert eng._graphs.replays == 5 * 8 - 1


@pytest.mark.cuda
def test_tp_shard_stays_eager_on_the_card(cuda):
    """Two gloo ranks sharing the card serve a TP-2 shard each: every
    step runs eagerly (share 0, nothing captured) and the ranks agree."""
    from torch_ranks import launch
    model = gpt.init_weights(gpt.Transformer(CARD_C2I), seed=3)
    with torch.no_grad():
        model.output.weight.normal_(0.0, 0.02,
                                    generator=torch.Generator().manual_seed(4))
    out = launch("tp_engine_on_card", 2, CARD_C2I, model.state_dict(),
                 timeout=300)
    for share, captured, _ in out:
        assert share == 0.0 and captured == 0
    np.testing.assert_array_equal(out[0][2], out[1][2])
