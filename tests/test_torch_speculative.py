"""Port speculative decoding (llamagen_tpu_torch.ops.speculative) against
the JAX package on the CPU, at GPT-nano size (block 64, vocab 512, random
heads): `warped_probs`, the greedy `spec_accept` chain, the sampled
`spec_accept`'s distribution (port RNG), `verify_step_slots` logits, and
greedy `generate_speculative` token-exact against JAX `generate` with an
unrelated draft, the target itself and a W4 copy of the target.

Tolerances: probabilities 1e-6; logits 2e-4 (the PARITY.md GPT logits
tolerance); the empirical distribution 5e-3 (200k draws, the JAX test's);
tokens exactly.
"""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import gpt as jgpt
from llamagen_tpu.ops import speculative as jspec
from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu_torch.config import gpt_config
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import speculative as spec
from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

TINY = gpt_config("GPT-nano", block_size=64, vocab_size=512, num_classes=10)
LABELS = np.array([0, 3, 7])


def _jax_greedy(params, cfg_scale, max_new=24):
    return np.asarray(jgenerate(
        params, jax.random.PRNGKey(2), jnp.asarray(LABELS),
        cfg=jax_config(TINY), max_new_tokens=max_new, cfg_scale=cfg_scale,
        sample_logits=False, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32, use_kernel=False))


def _spec_greedy(model, draft, cfg_scale, k=3, max_new=24, **kw):
    tok, rounds = spec.generate_speculative(
        model, draft, torch.tensor(LABELS), max_new_tokens=max_new, k=k,
        cfg_scale=cfg_scale, sample_logits=False,
        compute_dtype=torch.float32, **kw)
    return tok.numpy(), rounds


def test_warped_probs_matches_jax():
    logits = np.random.RandomState(1).randn(4, 3, 32).astype(np.float32) * 3
    for t, k, p in ((0.8, 5, 0.9), (1.0, 0, 1.0), (1.3, 0, 0.7)):
        out = spec.warped_probs(torch.tensor(logits), t, k, p)
        ref = jspec.warped_probs(jnp.asarray(logits), t, k, p)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_spec_accept_greedy_chain_matches_jax():
    """Greedy acceptance commits exactly the target's argmax chain: rows
    accept 2, 0 and all 3 proposals."""
    v, k = 6, 3
    p_probs = np.random.RandomState(0).rand(3, k + 1, v).astype(np.float32)
    tgt = p_probs.argmax(-1)
    props = tgt[:, :k].copy()
    props[0, 2] = (tgt[0, 2] + 1) % v
    props[1, 0] = (tgt[1, 0] + 1) % v
    q_probs = np.full((3, k, v), 1 / v, np.float32)
    tok, n_new = spec.spec_accept(torch.tensor(props), torch.tensor(q_probs),
                                  torch.tensor(p_probs), sample_logits=False)
    jtok, jn = jspec.spec_accept(jax.random.PRNGKey(0), jnp.asarray(props),
                                 jnp.asarray(q_probs), jnp.asarray(p_probs),
                                 sample_logits=False)
    np.testing.assert_array_equal(n_new.numpy(), [3, 1, 4])
    np.testing.assert_array_equal(n_new.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_spec_accept_preserves_target_distribution():
    """One accept/resample step draws exactly from p for proposals drawn
    from another q (the speculative-sampling theorem), with the port's
    RNG: 200k rows in one batch."""
    v, n = 8, 200_000
    rng = np.random.RandomState(0)
    q = torch.softmax(torch.tensor(rng.randn(v) * 2.0), 0).float()
    p = torch.softmax(torch.tensor(rng.randn(v) * 2.0), 0).float()
    gen = torch.Generator().manual_seed(42)
    props = torch.multinomial(q, n, replacement=True, generator=gen)[:, None]
    tok, _ = spec.spec_accept(props, q.expand(n, 1, v),
                              p.expand(n, 2, v), gen)
    emp = np.bincount(tok[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(emp, p.numpy(), atol=5e-3)


def test_verify_step_slots_matches_jax():
    """C = 4 chunk forward at diverged per-row positions over a cache of
    finite garbage: logits and the cache rows below pos + C."""
    params, model = make_pair(TINY)
    jcfg = jax_config(TINY)
    rng = np.random.RandomState(0)
    b, c, smax = 2, 4, 32
    toks = rng.randint(0, TINY.vocab_size, (b, c))
    pos = np.asarray([4, 8], np.int32)
    f2 = 2 * TINY.kv_heads * TINY.head_dim
    kv = [rng.randn(b, smax, f2).astype(np.float32) * 0.5
          for _ in range(TINY.n_layer)]
    jlogits, jcache = jspec.verify_step_slots(
        params, jcfg, jnp.asarray(toks), jnp.asarray(pos),
        jgpt.KVCache(kv=tuple(jnp.asarray(x) for x in kv)),
        compute_dtype=jnp.float32)
    cache = gpt.KVCache([torch.tensor(x) for x in kv])
    logits = spec.verify_step_slots(model, torch.tensor(toks),
                                    torch.tensor(pos), cache, torch.float32)
    assert logits.shape == (b, c, TINY.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=0)
    for mine, ref in zip(cache.kv, jcache.kv):
        for r, p in enumerate(pos):
            np.testing.assert_allclose(mine[r, :p + c].numpy(),
                                       np.asarray(ref)[r, :p + c], atol=1e-5)


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0], ids=["no_cfg", "cfg"])
def test_greedy_token_exact_vs_jax_generate(cfg_scale):
    """An unrelated draft (low acceptance) still commits exactly the
    target's greedy chain, at least one token per round."""
    params, model = make_pair(TINY)
    _, draft = make_pair(TINY, seed=1)
    got, rounds = _spec_greedy(model, draft, cfg_scale)
    ref = _jax_greedy(params, cfg_scale)
    assert len(np.unique(ref)) > 4  # a real comparison
    np.testing.assert_array_equal(got, ref)
    assert rounds <= 23


def test_self_draft_greedy_accepts_everything():
    params, model = make_pair(TINY)
    k, max_new = 3, 24
    got, rounds = _spec_greedy(model, model, 2.0, k=k, max_new=max_new)
    np.testing.assert_array_equal(got, _jax_greedy(params, 2.0, max_new))
    # the first token comes from prefill, the other 23 in rounds of k + 1
    assert rounds == -(-(max_new - 1) // (k + 1))


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["g128", "per-channel"])
def test_w4_self_draft_token_exact(per_channel):
    """Self-speculation: a W4 copy of the target drafts for it."""
    params, model = make_pair(TINY)
    draft = quantize_gpt_params_w4k(copy.deepcopy(model),
                                    per_channel=per_channel)
    got, rounds = _spec_greedy(model, draft, 2.0)
    np.testing.assert_array_equal(got, _jax_greedy(params, 2.0))
    assert rounds <= 23


def test_force_accept_round_count():
    """The benchmark knob commits exactly min(force, k) + 1 per round."""
    _, model = make_pair(TINY)
    _, draft = make_pair(TINY, seed=1)
    k, max_new = 3, 25
    for force in (0, 2, k):
        tok, rounds = spec.generate_speculative(
            model, draft, torch.tensor([1]), max_new_tokens=max_new, k=k,
            cfg_scale=2.0, compute_dtype=torch.float32, force_accept=force,
            generator=torch.Generator().manual_seed(0))
        assert tok.shape == (1, max_new)
        assert rounds == -(-(max_new - 1) // (min(force, k) + 1))


def test_sampled_run_is_in_range_and_refuses_mismatched_drafts():
    _, model = make_pair(TINY)
    _, draft = make_pair(TINY, seed=1)
    tok, rounds = spec.generate_speculative(
        model, draft, torch.tensor([5, 9]), max_new_tokens=16, k=2,
        cfg_scale=1.5, top_k=50, compute_dtype=torch.float32,
        generator=torch.Generator().manual_seed(3))
    assert tok.shape == (2, 16) and 1 <= rounds <= 16
    assert tok.min() >= 0 and tok.max() < TINY.vocab_size
    other = gpt.Transformer(gpt_config("GPT-nano", block_size=64))
    with pytest.raises(ValueError, match="vocabularies"):
        spec.generate_speculative(model, other, torch.tensor([1]),
                                  max_new_tokens=4)


@pytest.mark.parametrize("draft_kind", ["other", "w4-self"])
def test_t2i_greedy_with_emb_masks_equals_generate(draft_kind):
    """t2i (120 caption tokens, pads 0, 37 and 119, CFG 4.0): greedy f32
    `generate_speculative(emb_masks=...)` commits exactly the tokens of
    the port's `generate(emb_masks=...)` and of JAX `generate`, with an
    unrelated draft and with a W4 copy of the target; the masks reach both
    prefills and every draft and verify step (`prefix_pad`)."""
    from llamagen_tpu_torch.ops.generate import generate
    from test_torch_t2i import T2I, captions, make_t2i_pair

    params, model = make_t2i_pair()
    draft = (make_t2i_pair(seed=1)[1] if draft_kind == "other"
             else quantize_gpt_params_w4k(copy.deepcopy(model)))
    emb, mask = captions([0, 37, 119], seed=4)
    kw = dict(max_new_tokens=48, cfg_scale=4.0, sample_logits=False,
              compute_dtype=torch.float32)
    emb_t, mask_t = torch.tensor(emb), torch.tensor(mask)
    got, rounds = spec.generate_speculative(model, draft, emb_t, k=3,
                                            emb_masks=mask_t, **kw)
    ref = generate(model, emb_t, emb_masks=mask_t,
                   cache_dtype=torch.float32, **kw)
    jref = jgenerate(params, jax.random.PRNGKey(0), jnp.asarray(emb),
                     cfg=jax_config(T2I), emb_masks=jnp.asarray(mask),
                     max_new_tokens=48, cfg_scale=4.0, sample_logits=False,
                     compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                     use_kernel=False)
    assert len(np.unique(ref.numpy())) > 8  # a real comparison
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref))
    assert rounds <= 47
