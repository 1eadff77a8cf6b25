"""Port AWQ (llamagen_tpu_torch.ops.awq) against the JAX package on the
CPU, on a 2-layer dim-128 GPT in f32 whose norms drive 8 salient channels
10x (so the search picks alphas above 0):

  - the folds are exact: logits before and after equalisation within 1e-4,
    with `kv_heads` None and 2 (the GQA-pooled wo / v fold);
  - the alpha chosen at each fold point of each layer equals JAX's;
  - the equalised weights equal JAX's within 1e-5 relative;
  - AWQ -> round-to-nearest W4 -> greedy W4 tokens run, in range.
"""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.ops import awq as jawq
from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import awq
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)


def _tiny(kv_heads=None):
    return GPTConfig(dim=128, n_layer=2, n_head=4, n_kv_head=kv_heads,
                     block_size=16, num_classes=10, vocab_size=128,
                     cls_token_num=1)


def _salient_pair(cfg):
    """JAX params and the port model on the same weights, the norms of
    both layers scaling channels 0-7 by 10."""
    params, _ = make_pair(cfg)
    layers = dict(params["layers"])
    for key in ("attention_norm", "ffn_norm"):
        layers[key] = layers[key].at[:, :8].multiply(10.0)
    params = dict(params, layers=layers)
    model = gpt.Transformer(cfg)
    model.load_state_dict(gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return params, model.eval()


def _calib(cfg, n=8):
    rng = np.random.RandomState(0)
    return (rng.randint(0, cfg.num_classes, size=(n,)),
            rng.randint(0, cfg.vocab_size, size=(n, 16)))


def _logits(model, labels, tokens):
    return gpt.forward_train(model, torch.tensor(labels),
                             torch.tensor(tokens[:, :-1]), train=False)[0]


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa2"])
def test_folds_exact_alphas_and_weights_match_jax(kv_heads, monkeypatch):
    cfg = _tiny(kv_heads)
    params, model = _salient_pair(cfg)
    labels, tokens = _calib(cfg)
    before = _logits(model, labels, tokens)
    chosen = awq.awq_equalize_gpt_params(
        model, torch.tensor(labels), torch.tensor(tokens), group_size=64,
        compute_dtype=torch.float32)
    after = _logits(model, labels, tokens)
    np.testing.assert_allclose(after.detach().numpy(),
                               before.detach().numpy(), atol=1e-4, rtol=0)

    # JAX's choices: its _search_scale's losses with its own margin rule
    picks = []

    def recording(*args, **kw):
        s, losses = search(*args, **kw)
        best = int(np.argmin(losses))
        picks.append(0 if losses[best] >= losses[0] * 0.98 else best)
        return s, losses

    search = jawq._search_scale
    monkeypatch.setattr(jawq, "_search_scale", recording)
    eq = jawq.awq_equalize_gpt_params(
        params, jax_config(cfg), jnp.asarray(labels), jnp.asarray(tokens),
        group_size=64, compute_dtype=jnp.float32)
    alphas = awq.DEFAULT_ALPHAS
    ours = [c[key] for c in chosen for key in ("wqkv", "ffn", "w2", "wo")]
    assert ours == [alphas[i] for i in picks]
    assert any(a > 0 for a in ours)  # the salient channels moved a scale
    ref = gpt_state_dict_from_jax(jax.tree.map(np.asarray, eq), cfg)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_awq_then_rtn_w4_greedy_tokens_run():
    cfg = _tiny()
    _, model = _salient_pair(cfg)
    labels, tokens = _calib(cfg)
    awq.awq_equalize_gpt_params(model, torch.tensor(labels),
                                torch.tensor(tokens), group_size=64,
                                compute_dtype=torch.float32)
    w4 = quantize_gpt_params_w4k(copy.deepcopy(model), group_size=64)
    tok = generate(w4, torch.tensor([1, 5]), max_new_tokens=12,
                   cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32, cache_dtype=torch.float32)
    assert tok.shape == (2, 12)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size


def test_search_scale_matches_jax_on_salient_inputs():
    """One fold point: the same losses (1e-5 relative), the same pick, the
    same scale."""
    from llamagen_tpu.ops.gptq import _group_table
    rng = np.random.RandomState(1)
    k, n = 128, 128
    x = rng.randn(4, 64, k).astype(np.float32)
    x[..., :8] *= 10.0
    w = rng.randn(k, n).astype(np.float32) * 0.05
    gid, _, _ = _group_table(k, 64, False)
    s, losses, best = awq._search_scale(
        torch.tensor(x), [torch.tensor(w)], torch.tensor(gid).long(),
        int(gid.max()) + 1, awq.DEFAULT_ALPHAS, sample=256)
    js, jlosses = jawq._search_scale(
        jnp.asarray(x), [jnp.asarray(w)], jnp.asarray(gid),
        int(gid.max()) + 1, awq.DEFAULT_ALPHAS, sample=256)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert best > 0 and losses[best] < 0.9 * losses[0]
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
