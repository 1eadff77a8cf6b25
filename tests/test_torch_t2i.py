"""Port t2i conditioning and sampling (llamagen_tpu_torch.models.gpt,
ops.generate, cli.sample_t2i) against the JAX package on the CPU, at
GPT-nano width with the released 120 caption tokens: `embed_condition`
within 1e-5; `prefill` logits with left-padded `prefix_mask` (pads 0, 3,
96, 119) within 2e-4 (the PARITY.md GPT logits tolerance); teacher-forced
decode logits with `prefix_pad` (pads 0, 60, 96, 100, 119) over positions
120-191 (int8 flushes at 127, 159 and 191) on f32 and int8 caches within
2e-4, on a bf16 cache within 2^-10 of the largest logit; greedy f32
`generate(emb_masks=...)` tokens equal to JAX `generate`'s (f32 cache,
and W8A16 + int8 KV); the sampling CLI on a tiny local T5 directory."""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import gpt as jgpt
from llamagen_tpu.ops.attention import RECENT, RECENT_INT8
from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu_torch.cli import sample_t2i
from llamagen_tpu_torch.config import find_multiple, gpt_config, replace
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.attention import TAIL
from llamagen_tpu_torch.ops.generate import build_cfg_batch, generate
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

T = 120
T2I = gpt_config("GPT-nano", block_size=100, cls_token_num=T,
                 model_type="t2i", caption_dim=48, vocab_size=4096)


def make_t2i_pair(cfg=T2I, seed=0):
    """JAX t2i params (f32, random head) and the port model on the same
    weights through `gpt_state_dict_from_jax`."""
    params = jgpt.init_params(jax.random.PRNGKey(seed), jax_config(cfg))
    rng = np.random.RandomState(seed)
    params["output"] = jnp.asarray(
        rng.randn(cfg.dim, cfg.vocab_size).astype(np.float32) * 0.5)
    model = gpt.Transformer(cfg)
    model.load_state_dict(gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return params, model.eval()


def captions(pads, cfg=T2I, seed=1):
    """Left-padded caption features [B, T, caption_dim] (zeros on the pad
    rows, as `left_pad_embeddings` leaves them) and their masks [B, T]."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(len(pads), T, cfg.caption_dim).astype(np.float32)
    mask = (np.arange(T)[None, :] >= np.asarray(pads)[:, None])
    emb[~mask] = 0.0
    return emb, mask


@pytest.fixture(scope="module")
def pair():
    return make_t2i_pair()


def test_embed_condition_matches_jax(pair):
    """The caption MLP, and CFG dropout at probability 1: every caption is
    replaced by `uncond_embedding`, which `build_cfg_batch` also uses."""
    params, model = pair
    emb, _ = captions([0, 7])
    out = model.embed_condition(torch.tensor(emb))
    ref = jgpt.embed_condition(params, jax_config(T2I), jnp.asarray(emb))
    assert out.shape == (2, T, T2I.dim)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    dropped = copy.deepcopy(model)
    dropped.cfg = replace(T2I, class_dropout_prob=1.0)
    out = dropped.embed_condition(torch.tensor(emb),
                                  torch.Generator().manual_seed(0))
    null = build_cfg_batch(model, torch.tensor(emb), True)[2:]
    ref = jgpt.embed_condition(params, jax_config(T2I),
                               jnp.asarray(null.detach().numpy()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)


def test_init_weights_null_caption_scale():
    model = gpt.init_weights(gpt.Transformer(replace(T2I, caption_dim=2048)))
    std = model.cls_embedding.uncond_embedding.std().item()
    assert abs(std - 2048 ** -0.5) < 2e-3
    assert abs(model.cls_embedding.cap_proj.fc1.weight.std().item()
               - 0.02) < 2e-3


def test_prefill_with_prefix_mask_matches_jax(pair):
    """Pads 0, 3, 96 and 119 (one valid token): logits and the cache rows
    [0, T); a pad query row attends to itself only."""
    params, model = pair
    jcfg = jax_config(T2I)
    emb, mask = captions([0, 3, 96, 119])
    jcache = jgpt.init_cache(jcfg, 4, 128, dtype=jnp.float32)
    jl, jcache = jgpt.prefill(params, jcfg, jnp.asarray(emb), jcache,
                              prefix_mask=jnp.asarray(mask),
                              compute_dtype=jnp.float32)
    cache = gpt.init_cache(T2I, 4, 128, torch.float32, "cpu")
    logits = gpt.prefill(model, torch.tensor(emb), cache, torch.float32,
                         prefix_mask=torch.tensor(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)
    for mine, ref in zip(cache.kv, jcache.kv):
        assert torch.isfinite(mine).all()
        np.testing.assert_allclose(mine[:, :T].numpy(),
                                   np.asarray(ref)[:, :T], atol=2e-4)


@pytest.mark.parametrize("cache_kind", ["f32", "bf16", "int8"])
def test_teacher_forced_decode_with_prefix_pad_matches_jax(pair, cache_kind):
    """Prefill with the masks, then decode steps at positions 120-191 with
    `prefix_pad` (JAX `decode_step_pallas`, Pallas in interpret mode): pad
    96 puts every valid row in the int8 tail; pad 100 and 119 pass the
    tail base; the flushes quantise pad rows (zero k / v). The f32 cache
    comes from each side's own prefill; the bf16 and int8 caches (and the
    int8 tail) start from JAX's prefill on both sides, since rounding f32
    rows that differ in their last bits to bf16 or int8 flips a level now
    and then (one int8 level moves a logit by ~6e-4)."""
    params, model = pair
    jcfg = jax_config(T2I)
    pads = [0, 60, 96, 100, 119]
    b, smax = len(pads), 256
    emb, mask = captions(pads, seed=2)
    int8 = cache_kind == "int8"
    rows = find_multiple(T + RECENT_INT8, 8) if int8 else smax
    jdt = jnp.bfloat16 if cache_kind == "bf16" else jnp.float32
    jcache = jgpt.init_cache(jcfg, b, rows, dtype=jdt)
    _, jcache = jgpt.prefill(params, jcfg, jnp.asarray(emb), jcache,
                             prefix_mask=jnp.asarray(mask),
                             compute_dtype=jnp.float32)
    w = RECENT_INT8 if int8 else RECENT
    recent = tuple(c[:, T // w * w:][:, :w] for c in jcache.kv)

    def port(x):  # a JAX array as a torch tensor of its dtype
        dt = {jnp.dtype(jnp.float32): torch.float32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.int8): torch.int8}[x.dtype]
        return torch.tensor(np.asarray(x.astype(jnp.float32))).to(dt)

    if cache_kind == "f32":
        cache = gpt.init_cache(T2I, b, rows, torch.float32, "cpu")
        gpt.prefill(model, torch.tensor(emb), cache, torch.float32,
                    prefix_mask=torch.tensor(mask))
    elif cache_kind == "bf16":
        cache = gpt.KVCache([port(c) for c in jcache.kv])
    else:
        tail = [port(r) for r in recent]
        jcache = jgpt.quantize_cache(jcache, jcfg, smax)
        cache = gpt.KVCache(
            [port(c) for c in jcache.kv],
            kv_scale=[port(s)[..., ::64].contiguous()
                      for s in jcache.kv_scale], tail=tail)
        assert cache.kv_scale[0].shape == (b, smax, 2) and TAIL == w
    jpad = jnp.asarray(T - mask.sum(1), jnp.int32)
    pad = torch.tensor(T - mask.sum(1), dtype=torch.int32)
    step = jax.jit(lambda tok, pos, c, r: jgpt.decode_step_pallas(
        params, jcfg, tok, pos, c, r, prefix_pad=jpad,
        compute_dtype=jnp.float32, interpret=True))
    rng = np.random.RandomState(3)
    for pos in range(T, T + 72):
        tok = rng.randint(0, T2I.vocab_size, size=(b,))
        jl, jcache, recent = step(jnp.asarray(tok), jnp.int32(pos), jcache,
                                  recent)
        logits = gpt.decode_step(model, torch.tensor(tok), pos, cache,
                                 compute_dtype=torch.float32, prefix_pad=pad)
        # bf16: each step's new k / v row is rounded to bf16 from f32 rows
        # that differ in their last bits, so a flip is always possible:
        # 2^-10 of the largest logit
        tol = 2 ** -10 * np.abs(np.asarray(jl)).max() \
            if cache_kind == "bf16" else 2e-4
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=tol, rtol=0, err_msg=f"pos {pos}")
    if int8:  # the pad rows' zero k / v quantised at the flushes: no NaN
        for c, s in zip(cache.kv, cache.kv_scale):
            assert torch.isfinite(s.float()).all()
            assert not c[4, :T - 1].any()  # pad 119: rows 0..118 are pad


@pytest.mark.parametrize("path", ["f32", "w8a16-int8kv"])
def test_greedy_generate_tokens_match_jax(pair, path):
    """72 greedy tokens (positions 120-191) with CFG 4.0, pads 0, 37 and
    119: the port's `generate(emb_masks=...)` against JAX `generate`
    (f32: its XLA path with `prefix_allow`; int8: its kernel path with
    `prefix_pad`, Pallas in interpret mode)."""
    params, model = pair
    int8 = path == "w8a16-int8kv"
    if int8:
        params, model = jquantize(params), \
            quantize_gpt_params(copy.deepcopy(model))
    emb, mask = captions([0, 37, 119], seed=4)
    kw = dict(max_new_tokens=72, cfg_scale=4.0, sample_logits=False)
    jtok = jgenerate(params, jax.random.PRNGKey(0), jnp.asarray(emb),
                     cfg=jax_config(T2I), emb_masks=jnp.asarray(mask),
                     use_kernel=int8, compute_dtype=jnp.float32,
                     cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)
    tok = generate(model, torch.tensor(emb), emb_masks=torch.tensor(mask),
                   compute_dtype=torch.float32,
                   cache_dtype=torch.int8 if int8 else torch.float32, **kw)
    assert tok.shape == (3, 72) and len(np.unique(tok.numpy())) > 8
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_masks_change_the_tokens(pair):
    """A left pad is not a no-op: the same features with another mask give
    other tokens (the mask reaches prefill and decode)."""
    _, model = pair
    emb, mask = captions([0, 0], seed=5)
    kw = dict(max_new_tokens=16, cfg_scale=4.0, sample_logits=False,
              compute_dtype=torch.float32, cache_dtype=torch.float32)
    a = generate(model, torch.tensor(emb), emb_masks=torch.tensor(mask),
                 **kw)
    mask[:, :50] = False
    b = generate(model, torch.tensor(emb), emb_masks=torch.tensor(mask),
                 **kw)
    assert (a != b).any()


def test_sample_t2i_cli_on_a_local_t5(tmp_path):
    """`sample_t2i --device cpu` with `--t5-path` (a tiny local T5 of
    d_model 2048, test_torch_t5.make_tiny_t5_dir) and without it (random
    caption features, a warning)."""
    from test_torch_t5 import make_tiny_t5_dir

    t5_dir = make_tiny_t5_dir(tmp_path / "t5")
    for extra in (["--t5-path", t5_dir], []):
        out = tmp_path / "grid.png"
        res = sample_t2i.main(["--gpt-model", "GPT-nano", "--device", "cpu",
                               "--prompts", "a blue dog", "the horse",
                               "--precision", "f32", "--out", str(out)]
                              + extra)
        assert res.tokens.shape == (2, 256)
        assert res.tokens.min() >= 0 and res.tokens.max() < 16384
        assert res.images.shape == (2, 256, 256, 3)
        assert np.isfinite(res.images).all() and out.stat().st_size > 0
