"""Port speculative serving engine (llamagen_tpu_torch.serve.spec_engine)
against the JAX package on the CPU, at GPT-nano size in f32 (block 64,
vocab 512, random heads; JAX on its XLA path, `use_kernel=False`), the
seven contracts of `tests/test_spec_engine.py`:

  1. greedy tokens equal JAX `generate`'s and the JAX `SpecEngine`'s, and
     the port's `ServeEngine`'s (an unrelated draft: low acceptance);
  2. a self-draft accepts everything: ceil((max_new - 1) / (k + 1)) rounds;
  3. per-slot cfg scales in one batch equal per-request `generate`;
  4. 6 requests through 2 slots (slot reuse);
  5. t2i with left-padded captions (`prefix_pad` through both caches);
  6. sampled mode gives in-range ids;
  7. the refusals (penalties, tensor parallelism, a mismatched draft);

and `warped_probs_per_slot` against JAX's (1e-6), `spec_accept_per_slot`'s
sampled rows keep the target's distribution beside a greedy row (chi^2,
p > 1e-3), and a W4 draft under its W8A16 parent (the configuration the
engine serves) commits the parent's greedy tokens. Tokens exactly."""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from scipy import stats

from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu.serve import spec_engine as jspec_engine
from llamagen_tpu.serve.engine import SamplingParams as JSamplingParams
from llamagen_tpu_torch.config import gpt_config
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
from llamagen_tpu_torch.serve import spec_engine
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
from llamagen_tpu_torch.serve.spec_engine import SpecEngine
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

TINY = gpt_config("GPT-nano", block_size=64, vocab_size=512, num_classes=10)
GREEDY = SamplingParams(cfg_scale=2.0, temperature=0.0)
F32 = dict(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX target params, port target, port draft): the draft is an
    unrelated model (other weights), so proposals are often rejected."""
    params, target = make_pair(TINY, seed=0)
    _, draft = make_pair(TINY, seed=1)
    return params, target, draft


def _jax_greedy(params, labels, max_new, cfg_scale=2.0, cfg=TINY, **kw):
    return np.asarray(jgenerate(
        params, jax.random.PRNGKey(2), jnp.asarray(labels),
        cfg=jax_config(cfg), max_new_tokens=max_new, cfg_scale=cfg_scale,
        sample_logits=False, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, use_kernel=False, **kw))


def test_greedy_matches_jax_generate_jax_spec_engine_and_serve_engine(
        models):
    params, target, draft = models
    labels = [0, 3, 7, 1, 4]
    eng = SpecEngine(target, draft, num_pairs=4, max_new_tokens=24, k=3,
                     sampling_params=GREEDY, **F32)
    got = eng.generate(labels)
    np.testing.assert_array_equal(got, _jax_greedy(params, labels, 24))
    jparams_d = make_pair(TINY, seed=1)[0]
    jeng = jspec_engine.SpecEngine(
        params, jparams_d, jax_config(TINY), jax_config(TINY), num_pairs=4,
        max_new_tokens=24, k=3,
        sampling_params=JSamplingParams(cfg_scale=2.0, temperature=0.0),
        compute_dtype=jnp.float32, use_kernel=False)
    np.testing.assert_array_equal(got, jeng.generate(labels))
    base = ServeEngine(target, num_pairs=4, max_new_tokens=24,
                       sampling_params=GREEDY, **F32)
    np.testing.assert_array_equal(got, base.generate(labels))
    st = eng.stats()
    # the gauges of both JAX engines and of the port's ServeEngine
    assert set(jeng.stats()) <= set(st) and set(base.stats()) <= set(st)
    assert st["completed"] == 5 and st["running"] == 0
    assert st["tokens_per_round_per_slot"] >= 1.0
    assert 0 < st["ttft_mean_s"] <= st["e2e_latency_mean_s"]
    assert eng.admissions == 2  # 4 slots at once, then the fifth request


def test_self_draft_accepts_everything(models):
    """The first token comes from the admission; the other 24 commit k + 1
    = 4 a round."""
    params, target, _ = models
    eng = SpecEngine(target, target, num_pairs=2, max_new_tokens=25, k=3,
                     sampling_params=GREEDY, **F32)
    got = eng.generate([1, 2])
    np.testing.assert_array_equal(got, _jax_greedy(params, [1, 2], 25))
    assert eng.stats()["acceptance_rate"] == pytest.approx(1.0)
    assert eng.rounds == -(-(25 - 1) // 4)


def test_force_accept_commits_a_fixed_count(models):
    """The benchmark harness's force_accept: min(force_accept, k) + 1
    tokens a slot and round, whatever the acceptance test says (an
    unrelated draft), so 24 tokens after the first take 8 rounds."""
    _, target, draft = models
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=25, k=3,
                     force_accept=2, **F32)
    got = eng.generate([1, 2])
    assert eng.rounds == 24 // 3 and got.shape == (2, 25)
    assert eng.stats()["tokens_per_round_per_slot"] == pytest.approx(3.0)


def test_per_slot_cfg_scales_in_one_batch(models):
    params, target, draft = models
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=16, k=2,
                     sampling_params=GREEDY, **F32)
    reqs = [eng.submit(label, sp=SamplingParams(cfg_scale=s,
                                                temperature=0.0))
            for label, s in ((3, 1.5), (5, 3.0))]
    eng.run_until_idle()
    for req, s in zip(reqs, (1.5, 3.0)):
        np.testing.assert_array_equal(
            req.result, _jax_greedy(params, [req.label], 16, s)[0])


def test_six_requests_through_two_slots(models):
    params, target, draft = models
    labels = [0, 1, 2, 3, 4, 5]
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=12, k=2,
                     sampling_params=GREEDY, **F32)
    got = eng.generate(labels)
    np.testing.assert_array_equal(got, _jax_greedy(params, labels, 12))
    assert eng.stats()["completed"] == 6 and eng.admissions >= 3


def test_t2i_left_padded_captions():
    """Captions of 6 tokens, pads 2, 0 and 4 (the third reuses a slot):
    the caption prefill and `prefix_pad` run in both models' caches."""
    cfg = gpt_config("GPT-nano", block_size=64, vocab_size=512,
                     model_type="t2i", cls_token_num=6, caption_dim=32)
    params, target = make_pair(cfg, seed=0)
    _, draft = make_pair(cfg, seed=1)
    rng = np.random.RandomState(0)
    masks = np.ones((3, 6), bool)
    masks[0, :2] = False
    masks[2, :4] = False
    caps = rng.randn(3, 6, 32).astype(np.float32) * masks[..., None]
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=16, k=2,
                     sampling_params=GREEDY, **F32)
    got = eng.generate_t2i(caps, masks)
    ref = _jax_greedy(params, caps, 16, cfg=cfg,
                      emb_masks=jnp.asarray(masks))
    np.testing.assert_array_equal(got, ref)
    assert eng.state.prefix_pad.tolist() in ([4, 0], [2, 4], [4, 2])


def test_sampled_mode_in_range(models):
    _, target, draft = models
    eng = SpecEngine(target, draft, num_pairs=2, max_new_tokens=16, k=2,
                     sampling_params=SamplingParams(
                         cfg_scale=1.5, temperature=1.0, top_k=50,
                         top_p=0.9), **F32)
    got = eng.generate([1, 2, 3])
    assert got.shape == (3, 16)
    assert ((got >= 0) & (got < TINY.vocab_size)).all()
    assert 0.0 <= eng.stats()["acceptance_rate"] <= 1.0


def test_refusals(models):
    _, target, draft = models
    with pytest.raises(ValueError, match="penalties"):
        SpecEngine(target, draft, sampling_params=SamplingParams(
            presence_penalty=0.5), max_new_tokens=8, **F32)
    eng = SpecEngine(target, draft, num_pairs=1, max_new_tokens=8, **F32)
    with pytest.raises(ValueError, match="penalties"):
        eng.submit(1, sp=SamplingParams(repetition_penalty=1.2))
    with pytest.raises(ValueError, match="class labels"):
        eng.submit_caption(np.zeros((1, 2048)), np.ones(1))
    with pytest.raises(NotImplementedError):
        SpecEngine(target, draft, tp=2, max_new_tokens=8, **F32)
    with pytest.raises(NotImplementedError):
        SpecEngine(target, draft, mesh=object(), max_new_tokens=8, **F32)
    other = make_pair(gpt_config("GPT-nano", block_size=64, vocab_size=256,
                                 num_classes=10))[1]
    with pytest.raises(ValueError, match="vocabularies"):
        SpecEngine(target, other, max_new_tokens=8, **F32)
    other = make_pair(gpt_config("GPT-nano", block_size=64, vocab_size=512,
                                 num_classes=10, cls_token_num=2))[1]
    with pytest.raises(ValueError, match="geometry"):
        SpecEngine(target, other, max_new_tokens=8, **F32)


def test_warped_probs_per_slot_matches_jax():
    """[P, C, V] and [P, V] logits with per-row temperatures (greedy rows
    too), top-k and top-p; the host's filters_off gate equals filtering
    when every filter is off."""
    logits = np.random.RandomState(1).randn(4, 3, 64).astype(np.float32) * 3
    temp = np.array([0.8, 0.0, 1.3, 1.0], np.float32)
    top_k = np.array([5, 0, 0, 20], np.int32)
    top_p = np.array([0.9, 1.0, 0.7, 1.0], np.float32)
    for lg in (logits, logits[:, 0]):
        out = spec_engine.warped_probs_per_slot(
            torch.tensor(lg), torch.tensor(temp), torch.tensor(top_k),
            torch.tensor(top_p))
        ref = jspec_engine.warped_probs_per_slot(
            jnp.asarray(lg), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    off = [torch.tensor(temp), torch.zeros(4, dtype=torch.int32),
           torch.ones(4)]
    np.testing.assert_array_equal(
        spec_engine.warped_probs_per_slot(torch.tensor(logits), *off),
        spec_engine.warped_probs_per_slot(torch.tensor(logits), *off,
                                          filters_off=True))


def test_spec_accept_per_slot_keeps_the_target_distribution():
    """40k sampled rows with a greedy row among them: each sampled row's
    first committed token is drawn from p (chi^2 over the 8 ids), and the
    greedy row commits the argmax chain (JAX's greedy branch)."""
    v, k, n = 8, 2, 40_000
    rng = np.random.RandomState(0)
    q = torch.softmax(torch.tensor(rng.randn(v) * 2.0), 0).float()
    p = torch.softmax(torch.tensor(rng.randn(v) * 2.0), 0).float()
    gen = torch.Generator().manual_seed(7)
    props = torch.multinomial(q, n * k, replacement=True,
                              generator=gen).reshape(n, k)
    greedy = torch.zeros(n, dtype=torch.bool)
    greedy[n // 2] = True
    props[n // 2] = p.argmax()  # the greedy row's proposals are p's argmax
    tok, n_new = spec_engine.spec_accept_per_slot(
        props, q.expand(n, k, v), p.expand(n, k + 1, v), greedy, gen)
    assert tok[n // 2].tolist() == [int(p.argmax())] * (k + 1)
    assert int(n_new[n // 2]) == k + 1
    first = tok[~greedy, 0].numpy()
    counts = np.bincount(first, minlength=v)
    pe = p.double().numpy() / p.double().sum().item()
    _, pval = stats.chisquare(counts, pe * len(first))
    assert pval > 1e-3, pval
    jtok, jn = jspec_engine.spec_accept_per_slot(
        jax.random.PRNGKey(0), jnp.asarray(props[n // 2:n // 2 + 1].numpy()),
        jnp.asarray(q.expand(1, k, v).numpy()),
        jnp.asarray(p.expand(1, k + 1, v).numpy()), jnp.asarray([True]))
    np.testing.assert_array_equal(np.asarray(jtok)[0], tok[n // 2].numpy())


@pytest.mark.parametrize("kind", ["rtn", "gptq"])
def test_w4_self_draft_under_its_w8a16_parent(models, kind):
    """The engine's configuration: a W8A16 target (layers and int8 head)
    and a W4 g64 copy of it drafting (round-to-nearest, or GPTQ on random
    calibration ids); greedy tokens equal the port's `generate` on the
    W8A16 target, which the W4 draft never changes."""
    from llamagen_tpu_torch.ops.gptq import gptq_quantize_gpt_params
    _, target, _ = models
    w8 = quantize_gpt_params(copy.deepcopy(target), quantize_head=True)
    w4 = copy.deepcopy(target)
    if kind == "gptq":
        rng = np.random.RandomState(0)
        gptq_quantize_gpt_params(
            w4, torch.tensor(rng.randint(0, 10, 8)),
            torch.tensor(rng.randint(0, 512, (8, 16))), group_size=64,
            int8_head=True, compute_dtype=torch.float32)
    else:
        quantize_gpt_params_w4k(w4, group_size=64, int8_head=True)
    eng = SpecEngine(w8, w4, num_pairs=2, max_new_tokens=20, k=4,
                     sampling_params=GREEDY, **F32)
    got = eng.generate([2, 6, 9])
    ref = generate(w8, torch.tensor([2, 6, 9]), max_new_tokens=20,
                   cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref.numpy())
    assert eng.stats()["acceptance_rate"] > 0.2
