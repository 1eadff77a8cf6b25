"""Port GPT (llamagen_tpu_torch.models.gpt) against JAX `models.gpt`:
prefill and decode logits within 2e-4 at f32 (the PARITY.md GPT logits
tolerance), on the same weights through the converter."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu import config as jconfig
from llamagen_tpu.models import gpt as jgpt
from llamagen_tpu.ops.attention import RECENT, RECENT_INT8
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu_torch.config import GPTConfig, gpt_config
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.attention import TAIL
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax

NANO = gpt_config("GPT-nano", block_size=144)
GQA = GPTConfig(dim=256, n_layer=2, n_head=4, n_kv_head=2, block_size=144)


def jax_config(cfg):
    """The JAX package's config (`llamagen_tpu.config`) with the fields of
    a port config (`llamagen_tpu_torch.config`): the port and the JAX
    package each get their own config class."""
    return getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tier-1 run puts several pytest workers on the CPU; PyTorch's own
    intra-op threads on top of them multiply its wall time (measured ~2.5x
    for these files). Other test files import this fixture too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pair(cfg, seed=0):
    """JAX params (f32, random head) and the port model on the same
    weights."""
    params = jgpt.init_params(jax.random.PRNGKey(seed), jax_config(cfg))
    rng = np.random.RandomState(seed)
    params["output"] = jnp.asarray(
        rng.randn(cfg.dim, cfg.vocab_size).astype(np.float32) * 0.5)
    model = gpt.Transformer(cfg)
    model.load_state_dict(gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return params, model.eval()


@pytest.mark.parametrize("cfg", [NANO, GQA], ids=["nano", "gqa"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "w8a16_int8kv"])
def test_prefill_and_decode_logits_match_jax(cfg, int8):
    """Prefill, then teacher-forced decode steps across the 8-row window,
    the 32-row int8 flush (pos 31) and into the next tail."""
    params, model = make_pair(cfg)
    if int8:
        params = jquantize(params)
        quantize_gpt_params(model)
    jcfg = jax_config(cfg)
    b, t = 2, cfg.cls_token_num
    labels = np.array([3, 7])
    stage_len = 40 if int8 else 256
    jcache = jgpt.init_cache(jcfg, b, stage_len, dtype=jnp.float32)
    jl, jcache = jgpt.prefill(params, jcfg, jnp.asarray(labels), jcache,
                              compute_dtype=jnp.float32)
    cache = gpt.init_cache(cfg, b, stage_len, torch.float32, "cpu")
    logits = gpt.prefill(model, torch.tensor(labels), cache, torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)

    w = RECENT_INT8 if int8 else RECENT
    recent = tuple(c[:, :w] for c in jcache.kv)
    if int8:
        stage = cache
        jcache = jgpt.quantize_cache(jcache, jcfg, 256)
        cache = gpt.quantize_cache(stage, cfg, 256)
        cache.tail = [c[:, :TAIL].clone() for c in stage.kv]
    else:
        cache.kv = [torch.cat([c, torch.zeros_like(c)], 1)[:, :256]
                    for c in cache.kv]
    step = jax.jit(lambda tok, pos, c, r: jgpt.decode_step_pallas(
        params, jcfg, tok, pos, c, r, compute_dtype=jnp.float32,
        interpret=True))
    rng = np.random.RandomState(1)
    for i in range(34 if int8 else 10):
        pos = t + i
        tok = rng.randint(0, cfg.vocab_size, size=(b,))
        jl, jcache, recent = step(jnp.asarray(tok), jnp.int32(pos), jcache,
                                  recent)
        logits = gpt.decode_step(model, torch.tensor(tok), pos, cache,
                                 compute_dtype=torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=2e-4, rtol=0, err_msg=f"pos {pos}")


def test_rope_table_matches_jax():
    cfg = gpt_config("GPT-L", block_size=576)
    model = gpt.Transformer(cfg, device="meta")
    table = gpt._freqs_cis_2d_np(cfg.grid_size, cfg.head_dim, cfg.rope_base,
                                 cfg.cls_token_num)
    np.testing.assert_array_equal(
        table, np.asarray(jgpt.freqs_cis_2d(jax_config(cfg))))
    assert model.freqs_cis.shape == (577, 32, 2)


def test_quantized_state_dict_matches_jax_layout():
    """W8A16: the `_q` / `_scale` entries equal JAX quantize_gpt_params'
    (transposed per layer); the head stays unquantised by default."""
    params, model = make_pair(NANO)
    jq = jquantize(params)
    sd = quantize_gpt_params(model).state_dict()
    assert "output.weight" in sd and "output.weight_q" not in sd
    for i in range(NANO.n_layer):
        for key, name in (("wqkv", "attention.wqkv"), ("w2", "feed_forward.w2")):
            np.testing.assert_array_equal(
                sd[f"layers.{i}.{name}.weight_q"].numpy(),
                np.asarray(jq["layers"][key + "_q"][i]))
            np.testing.assert_array_equal(
                sd[f"layers.{i}.{name}.weight_scale"].numpy(),
                np.asarray(jq["layers"][key + "_scale"][i]))
    head = quantize_gpt_params(make_pair(NANO)[1], quantize_head=True)
    assert "output.weight_q" in head.state_dict()


def test_init_weights_zeroes_the_head():
    model = gpt.init_weights(gpt.Transformer(NANO), seed=0)
    assert torch.count_nonzero(model.output.weight) == 0
    assert torch.all(model.norm.weight == 1)
    std = model.layers[0].feed_forward.w1.weight.std().item()
    assert abs(std - 0.02) < 2e-3
