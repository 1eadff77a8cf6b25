"""Port sampling (llamagen_tpu_torch.ops.generate / sampling) against the
JAX package: greedy tokens equal to JAX `generate(use_kernel=True)` over
144 tokens (crossing the 128-row boundary of 4ab3b8d) at f32, the top-k /
top-p filters exactly, and the sampler's distribution by a chi-square test.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from scipy import stats

from llamagen_tpu.ops import sampling as jsampling
from llamagen_tpu.ops.generate import _kernel_supported
from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.config import GPTConfig
from test_torch_gpt import NANO, jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

LABELS = np.array([3, 7])
# GPT-3B's head_dim (100) in a small model
HD100 = GPTConfig(dim=200, n_layer=2, n_head=2, block_size=64)


def _both(params, model, cfg=NANO, use_kernel=True, **kw):
    kw = dict(max_new_tokens=cfg.block_size, sample_logits=False, **kw)
    jtok = jgenerate(params, jax.random.PRNGKey(0), jnp.asarray(LABELS),
                     cfg=jax_config(cfg), use_kernel=use_kernel, compute_dtype=jnp.float32,
                     cache_dtype=jnp.int8 if kw.get("int8") else jnp.float32,
                     **{k: v for k, v in kw.items() if k != "int8"})
    tok = generate(model, torch.tensor(LABELS), compute_dtype=torch.float32,
                   cache_dtype=torch.int8 if kw.get("int8") else torch.float32,
                   **{k: v for k, v in kw.items() if k != "int8"})
    return tok.numpy(), np.asarray(jtok)


@pytest.mark.parametrize("kw", [dict(cfg_scale=2.0), dict(cfg_scale=1.0),
                                dict(cfg_scale=2.0, cfg_interval=50)],
                         ids=["cfg", "no_cfg", "cfg_interval"])
def test_greedy_tokens_match_jax(kw):
    params, model = make_pair(NANO)
    tok, jtok = _both(params, model, **kw)
    assert tok.shape == (2, 144)
    np.testing.assert_array_equal(tok, jtok)


def test_greedy_tokens_match_jax_w8a16_int8_kv():
    params, model = make_pair(NANO)
    tok, jtok = _both(jquantize(params), quantize_gpt_params(model),
                      cfg_scale=2.0, int8=True)
    np.testing.assert_array_equal(tok, jtok)


def test_greedy_tokens_match_jax_head_dim_100():
    """head_dim 100 (GPT-3B's) end to end, f32: JAX takes its XLA decode
    path here (F = 200 is not 128-aligned, `generate._kernel_supported`;
    its int8 KV cache needs the kernel path), the port its kernels' plain
    versions; greedy tokens over 64 steps equal."""
    params, model = make_pair(HD100)
    assert not _kernel_supported(jax_config(HD100), warn=False)
    tok, jtok = _both(params, model, cfg=HD100, use_kernel=False,
                      cfg_scale=2.0)
    assert tok.shape == (2, 64)
    np.testing.assert_array_equal(tok, jtok)


def test_penalties_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 50).astype(np.float32)
    counts = rng.randint(0, 3, size=(3, 50)).astype(np.int32)
    kw = dict(presence=0.3, frequency=0.2, repetition=1.3)
    out = sampling.apply_penalties(torch.tensor(logits), torch.tensor(counts),
                                   **kw)
    ref = jsampling.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                    **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    c = sampling.update_output_counts(torch.tensor(counts),
                                      torch.tensor([0, 5, 49]))
    jc = jsampling.update_output_counts(jnp.asarray(counts),
                                        jnp.asarray([0, 5, 49]))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (40, 0.9),
                                         (1, 0.5)])
def test_filters_match_jax_exactly(top_k, top_p):
    rng = np.random.RandomState(top_k)
    logits = (rng.randn(4, 1000) * 2).astype(np.float32)
    logits[0, :3] = logits[0, 3]  # ties at a threshold are kept
    out = sampling.filter_logits(torch.tensor(logits), top_k, top_p)
    ref = jsampling.filter_logits(jnp.asarray(logits), top_k, top_p)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cfg_mix_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(4, 64).astype(np.float32)
    for enabled in (True, False):
        out = sampling.cfg_mix(torch.tensor(logits), 2.5, enabled=enabled)
        ref = jsampling.cfg_mix(jnp.asarray(logits), 2.5, enabled=enabled)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_distribution_chi_square():
    """Draws follow softmax(logits / T) restricted to the top-k set."""
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, -1.0, 2.0, -3.0, 0.2]])
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = sampling.sample(logits.expand(n, -1), gen, temperature=0.8,
                            top_k=6)
    counts = np.bincount(draws.numpy(), minlength=8)
    kept = torch.topk(logits[0], 6).indices.numpy()
    assert counts[np.setdiff1d(np.arange(8), kept)].sum() == 0
    p = torch.softmax(logits[0, kept].double() / 0.8, dim=0).numpy()
    _, pval = stats.chisquare(counts[kept], p * n)
    assert pval > 1e-3, pval
    greedy = sampling.sample(logits, sample_logits=False)
    assert greedy.item() == 5


@pytest.mark.parametrize("head", [False, True], ids=["layers", "head_too"])
def test_greedy_tokens_match_jax_int4_storage(head):
    """`quantize_gpt_params(..., bits=4)` (group 128): JAX's `_q4` / `_gs`
    tree carried by `gpt_state_dict_from_jax` equals the port's own
    quantisation bit for bit, and greedy f32 tokens equal JAX's."""
    from llamagen_tpu_torch.cli.common import shape_quantized_linears
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
    params, model = make_pair(NANO)
    jq = jquantize(params, quantize_head=head, bits=4)
    sd = gpt_state_dict_from_jax(jax.tree.map(np.asarray, jq), NANO)
    assert any(k.endswith("weight_q4") for k in sd)
    assert ("output.weight_q4" in sd) == head
    quantize_gpt_params(model, quantize_head=head, bits=4)
    own = model.state_dict()
    assert own.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(own[k], v), k
    loaded = gpt.Transformer(NANO)
    shape_quantized_linears(loaded, sd)
    loaded.load_state_dict(sd)
    tok, jtok = _both(jq, loaded.eval(), cfg_scale=2.0)
    np.testing.assert_array_equal(tok, jtok)
