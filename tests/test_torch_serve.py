"""Port serving engine (llamagen_tpu_torch.serve.engine) and per-slot
sampling (llamagen_tpu_torch.ops.sampling) against the JAX package on the
CPU: the per-slot functions equal JAX's on the same logits; greedy engine
tokens (f32 cache, and W8A16 + int8 KV across the pos 31 flush) equal the
JAX `ServeEngine`'s exactly, with slot reuse, staggered positions and
per-request parameters, and equal the port's own `generate`; so do the
t2i engine's (`submit_caption`, batched caption admission, `prefix_pad`),
f32 and W8A16 + int8 KV across the flushes at 127 and 159."""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from scipy import stats

from llamagen_tpu.ops import sampling as jsampling
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu.serve.engine import SamplingParams as JSamplingParams
from llamagen_tpu.serve.engine import ServeEngine as JServeEngine
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
from test_torch_gpt import NANO, jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

MAX_NEW = 48  # past the int8 flush at pos 31
LABELS = [3, 7, 1, 9, 4]


@pytest.fixture(scope="module")
def pair():
    return make_pair(NANO)


def _mixed_logits(seed=0):
    """[6, 512] f32 rows: spread, peaked, flat, with ties at the top."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 512) * np.array([[1], [3], [0.1], [2], [1],
                                             [5]])).astype(np.float32)
    logits[2, :4] = logits[2].max() + 1.0  # a four-way tie at the top
    logits[4, 10:20] = logits[4, 9]        # ties around a threshold
    return logits


def test_filter_logits_per_slot_matches_jax():
    logits = _mixed_logits()
    top_k = np.array([0, 1, 5, 40, 0, 600], np.int32)
    top_p = np.array([1.0, 0.5, 1.0, 0.9, 0.7, 0.95], np.float32)
    out = sampling.filter_logits_per_slot(
        torch.tensor(logits), torch.tensor(top_k), torch.tensor(top_p))
    ref = jsampling.filter_logits_per_slot(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_penalties_and_cfg_mix_per_slot_match_jax():
    """`apply_penalties` and `cfg_mix` with a [B] tensor per parameter equal
    JAX's per-slot variants; the counts update skips the rows not going."""
    logits = _mixed_logits(1)
    rng = np.random.RandomState(2)
    counts = rng.randint(0, 3, size=logits.shape).astype(np.int32)
    kw = dict(presence=np.array([0, 0.3, 0, 1, 0.5, 0], np.float32),
              frequency=np.array([0, 0.2, 0.1, 0, 0, 0], np.float32),
              repetition=np.array([1, 1.3, 1, 0.8, 2, 1], np.float32))
    out = sampling.apply_penalties(
        torch.tensor(logits), torch.tensor(counts),
        **{k: torch.tensor(v) for k, v in kw.items()})
    ref = jsampling.apply_penalties_per_slot(
        jnp.asarray(logits), jnp.asarray(counts),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # a row with every penalty off is left exactly as it was
    np.testing.assert_array_equal(out[0].numpy(), logits[0])
    scale = np.array([1.0, 2.0, 4.0], np.float32)
    out = sampling.cfg_mix(torch.tensor(logits), torch.tensor(scale))
    ref = jsampling.cfg_mix_per_slot(jnp.asarray(logits), jnp.asarray(scale))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    tokens = torch.tensor([0, 5, 5, 511, 7, 2])
    going = torch.tensor([True, False, True, True, False, True])
    c = sampling.update_output_counts(torch.tensor(counts), tokens, going)
    expect = counts.copy()
    expect[[0, 2, 3, 5], [0, 5, 511, 2]] += 1
    np.testing.assert_array_equal(c.numpy(), expect)


def test_sample_per_slot_greedy_rows_and_host_gate():
    """Temperature-0 rows are the argmax of their (filtered) logits; a
    top_k 1 row is greedy at any temperature; the host-side `filters_off`
    gate gives the same tokens as filtering when every filter is off."""
    logits = torch.tensor(_mixed_logits(3))
    temp = torch.tensor([0.0, 1.0, 0.0, 0.7, 1.0, 0.0])
    top_k = torch.tensor([0, 1, 5, 0, 0, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.8, 1.0, 1.0])
    tok = sampling.sample_per_slot(logits, temp, top_k, top_p,
                                   torch.Generator().manual_seed(0))
    greedy = logits.argmax(-1)
    for row in (0, 1, 2, 5):
        assert tok[row] == greedy[row]
    off_k, off_p = torch.zeros_like(top_k), torch.ones_like(top_p)
    a = sampling.sample_per_slot(logits, temp, off_k, off_p,
                                 torch.Generator().manual_seed(1))
    b = sampling.sample_per_slot(logits, temp, off_k, off_p,
                                 torch.Generator().manual_seed(1),
                                 filters_off=True)
    assert torch.equal(a, b)


def test_sample_per_slot_distribution_chi_square():
    """Uniform rows draw from softmax(logits / T) over the top-k set, as
    `sample` does (the chi-square test of test_torch_generate.py)."""
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, -1.0, 2.0, -3.0, 0.2]])
    n = 40000
    tok = sampling.sample_per_slot(
        logits.expand(n, -1), torch.full((n,), 0.8),
        torch.full((n,), 6, dtype=torch.int32), torch.ones(n),
        torch.Generator().manual_seed(0))
    counts = np.bincount(tok.numpy(), minlength=8)
    kept = torch.topk(logits[0], 6).indices.numpy()
    assert counts[np.setdiff1d(np.arange(8), kept)].sum() == 0
    p = torch.softmax(logits[0, kept].double() / 0.8, dim=0).numpy()
    _, pval = stats.chisquare(counts[kept], p * n)
    assert pval > 1e-3, pval


def _drive(eng, sp_of):
    """One request, one chunk, then four more: the second slot starts four
    steps behind the first (a position per row, flushes at other steps),
    and the last three requests reuse slots. Results in submission
    order."""
    reqs = [eng.submit(LABELS[0], sp=sp_of(0))]
    eng._admit_and_step()
    reqs += [eng.submit(l, sp=sp_of(i + 1)) for i, l in enumerate(LABELS[1:])]
    eng.run_until_idle()
    return np.stack([r.result for r in reqs])


@pytest.mark.parametrize("path", ["f32", "f32-pallas", "w8a16-int8kv"])
def test_engine_greedy_matches_jax_engine_and_generate(pair, path):
    """5 requests over 2 slots, chunk 4, cfg 2.0, temperature 0 and 1e-6 in
    turn: the port's engine, the JAX engine (XLA or Pallas interpret path)
    and the port's `generate` give the same tokens."""
    params, model = pair
    int8 = path == "w8a16-int8kv"
    if int8:
        params, model = jquantize(params), \
            quantize_gpt_params(copy.deepcopy(model))
    common = dict(num_pairs=2, max_new_tokens=MAX_NEW, chunk=4)
    temps = [0.0, 1e-6]
    jeng = JServeEngine(params, jax_config(NANO), compute_dtype=jnp.float32,
                        use_kernel=path != "f32",
                        cache_dtype=jnp.int8 if int8 else None, **common)
    if int8:
        # the JAX engine keeps its int8-cache windows in bf16 whatever the
        # compute dtype (engine.py:113-114); the port's tail is in the
        # compute dtype, as JAX `generate`'s window is: give the JAX engine
        # f32 windows to compare like with like
        jeng.state = jeng.state._replace(recent=tuple(
            jnp.zeros(r.shape, jnp.float32) for r in jeng.state.recent))
    jtok = _drive(jeng, lambda i: JSamplingParams(
        cfg_scale=2.0, temperature=temps[i % 2]))
    eng = ServeEngine(model, compute_dtype=torch.float32,
                      cache_dtype=torch.int8 if int8 else None, **common)
    tok = _drive(eng, lambda i: SamplingParams(cfg_scale=2.0,
                                               temperature=temps[i % 2]))
    ref = generate(model, torch.tensor(LABELS), max_new_tokens=MAX_NEW,
                   cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32,
                   cache_dtype=torch.int8 if int8 else torch.float32)
    assert tok.shape == (5, MAX_NEW)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(tok, ref.numpy())
    assert eng.state.cache.quantized == int8


def _greedy_ref(model, label, **kw):
    return generate(model, torch.tensor([label]), max_new_tokens=MAX_NEW,
                    sample_logits=False, compute_dtype=torch.float32,
                    cache_dtype=torch.float32, **kw)[0].numpy()


def test_per_request_cfg_scales_match_generate(pair):
    _, model = pair
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=MAX_NEW, chunk=4,
                      compute_dtype=torch.float32)
    reqs = [eng.submit(label, sp=SamplingParams(cfg_scale=s,
                                                temperature=0.0))
            for label, s in ((3, 1.5), (7, 4.0))]
    eng.run_until_idle()
    for req, s in zip(reqs, (1.5, 4.0)):
        np.testing.assert_array_equal(
            req.result, _greedy_ref(model, req.label, cfg_scale=s))


def test_top_k_one_is_greedy_beside_a_sampling_neighbour(pair):
    _, model = pair
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=MAX_NEW, chunk=4,
                      compute_dtype=torch.float32,
                      sampling_params=SamplingParams(cfg_scale=2.0))
    req = eng.submit(3, sp=SamplingParams(cfg_scale=2.0, top_k=1))
    other = eng.submit(7)  # samples at temperature 1, no filter
    eng.run_until_idle()
    greedy = _greedy_ref(model, 3, cfg_scale=2.0)
    np.testing.assert_array_equal(req.result, greedy)
    assert (other.result != _greedy_ref(model, 7, cfg_scale=2.0)).any()


def test_repetition_penalty_matches_generate(pair):
    _, model = pair
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=MAX_NEW, chunk=4,
                      compute_dtype=torch.float32, track_penalties=True)
    sp = SamplingParams(cfg_scale=2.0, temperature=0.0,
                        repetition_penalty=1.3, frequency_penalty=0.1)
    req = eng.submit(3, sp=sp)
    plain = eng.submit(7, sp=SamplingParams(cfg_scale=2.0, temperature=0.0))
    eng.run_until_idle()
    np.testing.assert_array_equal(
        req.result, _greedy_ref(model, 3, cfg_scale=2.0,
                                repetition_penalty=1.3,
                                frequency_penalty=0.1))
    np.testing.assert_array_equal(plain.result,
                                  _greedy_ref(model, 7, cfg_scale=2.0))
    assert (req.result != _greedy_ref(model, 3, cfg_scale=2.0)).any()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "w8a16-int8kv"])
def test_reused_slot_is_fresh(pair, int8):
    """A request in a reused slot (over another request's cache rows,
    scales and tail) gives the tokens of a fresh engine."""
    _, model = pair
    if int8:
        model = quantize_gpt_params(copy.deepcopy(model))
    kw = dict(num_pairs=1, max_new_tokens=MAX_NEW, chunk=16,
              compute_dtype=torch.float32,
              cache_dtype=torch.int8 if int8 else None,
              sampling_params=SamplingParams(cfg_scale=1.5, temperature=0.0))
    fresh = ServeEngine(model, **kw).generate([5])
    eng = ServeEngine(model, **kw)
    first = eng.generate([9])
    again = eng.generate([5])
    np.testing.assert_array_equal(again, fresh)
    assert (first != fresh).any()


def test_bookkeeping_and_stats(pair):
    params, model = pair
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=MAX_NEW, chunk=4,
                      compute_dtype=torch.float32)
    eng.generate([1, 2])  # both admitted at once: no queue wait
    st = eng.stats()
    jst = JServeEngine(params, jax_config(NANO), num_pairs=2,
                       max_new_tokens=MAX_NEW, chunk=4,
                       compute_dtype=jnp.float32).stats()
    # JAX's gauges, then the port's share of graph-replayed decode steps
    # (none on the CPU)
    assert list(st) == list(jst) + ["decode_graphed_share"]
    assert st["decode_graphed_share"] == 0.0
    assert st["completed"] == 2 and st["running"] == 0 \
        and st["waiting"] == 0 and st["slots"] == 2
    assert st["tpot_mean_s"] > 0 and st["throughput_img_per_s"] > 0
    # the first token is observed after the admission chunk's first step,
    # not at the chunk boundary
    assert st["ttft_p50_s"] <= st["e2e_latency_p50_s"] / 8
    assert eng.steps_run == MAX_NEW
    assert int(eng.state.pos.max()) == MAX_NEW < eng.cache_rows == 128
    eng.generate([3, 4, 5])
    assert eng.stats()["completed"] == 5
    assert int(eng.state.pos.max()) < eng.cache_rows
    eng.reset_stats()
    assert eng.stats()["completed"] == 0 and eng.stats()["ttft_p50_s"] is None
    eng._slot_pos[0] = eng.cache_rows  # a slot past the cache is refused
    with pytest.raises(RuntimeError, match="outside the cache"):
        eng._admit_and_step()


def test_empty_int8_cache():
    cache = gpt.init_cache(NANO, 3, 64, torch.int8, "cpu",
                           compute_dtype=torch.float32)
    assert cache.quantized and len(cache.kv) == NANO.n_layer
    assert cache.kv[0].dtype == torch.int8 and not cache.kv[0].any()
    assert cache.kv_scale[0].dtype == torch.bfloat16 \
        and cache.kv_scale[0].shape == (3, 64, 2) \
        and bool((cache.kv_scale[0] == 1).all())
    assert cache.tail[0].shape == (3, 32, 2 * NANO.dim) \
        and cache.tail[0].dtype == torch.float32 and not cache.tail[0].any()


def test_refuses_what_is_not_ported(pair):
    """A c2i engine refuses captions; per-request penalties need the
    counts buffer; max_new_tokens past the rope table is refused."""
    _, model = pair
    eng = ServeEngine(model, num_pairs=1, max_new_tokens=8,
                      compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="submit"):
        eng.submit_caption(np.zeros((1, 2048)), np.ones(1))
    with pytest.raises(ValueError, match="track_penalties"):
        eng.submit(1, sp=SamplingParams(repetition_penalty=1.2))
    with pytest.raises(ValueError, match="max_new_tokens"):
        ServeEngine(model, max_new_tokens=NANO.block_size + 1)


def _drive_t2i(eng, caps, masks, sp_of):
    """`_drive` for captions: one request, one chunk, then four more, the
    last three reusing slots."""
    reqs = [eng.submit_caption(caps[0], masks[0], sp=sp_of(0))]
    eng._admit_and_step()
    reqs += [eng.submit_caption(c, m, sp=sp_of(i + 1))
             for i, (c, m) in enumerate(zip(caps[1:], masks[1:]))]
    eng.run_until_idle()
    return np.stack([r.result for r in reqs])


@pytest.mark.parametrize("path", ["f32", "w8a16-int8kv"])
def test_t2i_engine_greedy_matches_jax_engine_and_generate(path):
    """5 caption requests (pads 0, 37, 96, 119, 60) over 2 slots, chunk 4,
    cfg 2.0, temperature 0 and 1e-6 in turn, 48 tokens (positions
    120-167): the port's t2i engine, the JAX t2i engine (f32: XLA; int8:
    Pallas interpret, f32 windows) and the port's `generate(emb_masks=...)`
    give the same tokens."""
    from test_torch_t2i import T2I, captions, make_t2i_pair

    params, model = make_t2i_pair()
    int8 = path == "w8a16-int8kv"
    if int8:
        params, model = jquantize(params), quantize_gpt_params(model)
    caps, masks = captions([0, 37, 96, 119, 60], seed=6)
    common = dict(num_pairs=2, max_new_tokens=MAX_NEW, chunk=4)
    temps = [0.0, 1e-6]
    jeng = JServeEngine(params, jax_config(T2I), compute_dtype=jnp.float32,
                        use_kernel=int8,
                        cache_dtype=jnp.int8 if int8 else None, **common)
    if int8:  # f32 windows, as in the c2i comparison above
        jeng.state = jeng.state._replace(recent=tuple(
            jnp.zeros(r.shape, jnp.float32) for r in jeng.state.recent))
    jtok = _drive_t2i(jeng, caps, masks, lambda i: JSamplingParams(
        cfg_scale=2.0, temperature=temps[i % 2]))
    eng = ServeEngine(model, compute_dtype=torch.float32,
                      cache_dtype=torch.int8 if int8 else None, **common)
    tok = _drive_t2i(eng, caps, masks, lambda i: SamplingParams(
        cfg_scale=2.0, temperature=temps[i % 2]))
    ref = generate(model, torch.tensor(caps), emb_masks=torch.tensor(masks),
                   max_new_tokens=MAX_NEW, cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32,
                   cache_dtype=torch.int8 if int8 else torch.float32)
    assert tok.shape == (5, MAX_NEW) and len(np.unique(tok)) > 8
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(tok, ref.numpy())
    assert eng.admissions == 5  # the staggered slots free one at a time


def test_t2i_bookkeeping_stats_and_refusals():
    """Two captions admitted in one prefill: each slot stands at T with its
    first token, finishes after max_new - 1 steps; stats() counts them
    (TTFT includes the admission prefill); a t2i engine refuses labels and
    captions of another shape; a reused slot gives a fresh slot's
    tokens."""
    from test_torch_t2i import T, T2I, captions, make_t2i_pair

    _, model = make_t2i_pair()
    caps, masks = captions([5, 90], seed=7)
    sp = SamplingParams(cfg_scale=3.0, temperature=0.0)
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=16, chunk=8,
                      compute_dtype=torch.float32, sampling_params=sp)
    with pytest.raises(ValueError, match="submit_caption"):
        eng.submit(3)
    with pytest.raises(ValueError, match="expected"):
        eng.submit_caption(caps[0][:, :8], masks[0])
    out = eng.generate_t2i(caps, masks)
    st = eng.stats()
    assert out.shape == (2, 16) and st["completed"] == 2
    assert eng.steps_run == 15 and eng.admissions == 1
    assert eng.state.pos.tolist() == [T + 15] * 2
    assert eng.state.prefix_pad.tolist() == [5, 90]
    # the first token is sampled by the admission prefill: TTFT counts it
    assert 0 < st["ttft_p50_s"] < st["e2e_latency_p50_s"] \
        and st["tpot_p50_s"] > 0
    fresh = ServeEngine(model, num_pairs=1, max_new_tokens=16, chunk=8,
                        compute_dtype=torch.float32, sampling_params=sp)
    again = eng.generate_t2i(caps[1:], masks[1:])  # slot 0 reused
    np.testing.assert_array_equal(again, fresh.generate_t2i(caps[1:],
                                                            masks[1:]))
    np.testing.assert_array_equal(again, out[1:])
    assert T2I.caption_dim == caps.shape[-1]
