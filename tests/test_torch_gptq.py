"""Port GPTQ (llamagen_tpu_torch.ops.gptq) against the JAX package on the
CPU, and JAX's quantised models carried into the port
(`utils/convert.py::gpt_state_dict_from_jax`).

Tolerances: on JAX's own W and H, the port's int4 levels equal JAX's on
>= 99.9 % of the entries (the count that differs is printed) and its
scales within 1e-5 relative; the H-weighted error tr(dW^T H dW) within 1 %
of JAX's and below round-to-nearest's (g128, g64, per channel). On a tiny
GPT, every matrix's weighted error within 1 % of JAX's. Greedy tokens of
JAX's GPTQ W4 and W8A16 models, loaded into the port, equal JAX's
exactly."""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.ops import gptq as jgptq
from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu.ops.w4_matmul import w4_dequant as jw4_dequant
from llamagen_tpu_torch.cli.common import shape_quantized_linears
from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import gptq
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.w4_matmul import _levels, pack_w4, w4_dequant
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

TINY = GPTConfig(dim=128, n_layer=2, n_head=2, block_size=16,
                 num_classes=10, vocab_size=128, cls_token_num=1)
MODES = {"g128": dict(group_size=128), "g64": dict(group_size=64),
         "pc": dict(per_channel=True)}


def _corr_inputs(rng, b, k):
    """Correlated activations (low rank + noise): where error compensation
    pays (iid inputs make H ~ I and GPTQ ~ round-to-nearest)."""
    basis = rng.randn(k, k // 4).astype(np.float32)
    z = rng.randn(b, k // 4).astype(np.float32)
    return z @ basis.T + 0.1 * rng.randn(b, k).astype(np.float32)


def _werr(dw: torch.Tensor, h: torch.Tensor) -> float:
    """tr(dW^T H dW) in f64."""
    dw, h = dw.double(), h.double()
    return float(torch.einsum("kn,kj,jn->", dw, h, dw))


@pytest.mark.parametrize("mode", list(MODES))
def test_matrix_matches_jax_and_beats_rtn(mode):
    rng = np.random.RandomState(0)
    k, n = 256, 128
    w = rng.randn(k, n).astype(np.float32) * 0.05
    x = _corr_inputs(rng, 4096, k)
    h = (x.T @ x / len(x)).astype(np.float32)
    kw = MODES[mode]
    jb, js = jgptq.gptq_quantize_matrix(jnp.asarray(w), jnp.asarray(h), **kw)
    b, s = gptq.gptq_quantize_matrix(torch.tensor(w), torch.tensor(h), **kw)
    lv, jlv = _levels(b), _levels(torch.tensor(np.asarray(jb)))
    differ = int((lv != jlv).sum())
    print(f"{mode}: {differ} of {lv.numel()} levels differ from JAX's")
    assert differ <= 1e-3 * lv.numel()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=0)
    ht, wt = torch.tensor(h), torch.tensor(w)
    err = _werr(w4_dequant(b, s) - wt, ht)
    jerr = _werr(torch.tensor(np.asarray(jw4_dequant(jb, js))) - wt, ht)
    rtn = _werr(w4_dequant(*pack_w4(wt, **kw)) - wt, ht)
    assert abs(err - jerr) <= 0.01 * jerr, (err, jerr)
    assert err < 0.9 * rtn, (err, rtn)


def _calib(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, TINY.num_classes, size=(n,)),
            rng.randint(0, TINY.vocab_size, size=(n, 16)))


def test_gpt_params_weighted_errors_match_jax():
    """Whole-model GPTQ (g64, f32 calibration) on a 2-layer GPT: each of
    the ten matrices' error, weighted by the Hessian the port's walk used
    (layer 1's from the quantised layer 0), within 1 % of JAX's."""
    params, model = make_pair(TINY)
    labels, tokens = _calib()
    qp = jgptq.gptq_quantize_gpt_params(
        params, jax_config(TINY), jnp.asarray(labels), jnp.asarray(tokens),
        group_size=64, compute_dtype=jnp.float32)
    orig = copy.deepcopy(model)
    hess = {}
    gptq.gptq_quantize_gpt_params(model, torch.tensor(labels),
                                  torch.tensor(tokens), group_size=64,
                                  compute_dtype=torch.float32, hessians=hess)
    assert sorted(hess) == list(range(TINY.n_layer))
    for l in range(TINY.n_layer):
        for key, lin in gptq.layer_linears(model.layers[l]).items():
            w = gptq.layer_linears(orig.layers[l])[key].weight.detach().t()
            jw = jw4_dequant(qp["layers"][key + "_w4b"][l],
                             qp["layers"][key + "_w4s"][l])
            err = _werr(w4_dequant(lin.weight_w4b, lin.weight_w4s) - w,
                        hess[l][key])
            jerr = _werr(torch.tensor(np.asarray(jw)) - w, hess[l][key])
            assert abs(err - jerr) <= 0.01 * jerr, (l, key, err, jerr)
    assert model.output.weight is not None  # no int8 head unless asked


@pytest.mark.parametrize("kind", ["gptq-w4", "w8a16"])
def test_jax_quantized_models_run_unchanged_in_the_port(kind):
    """JAX's GPTQ W4 model (g64, int8 head) and its W8A16 model (int8
    head) -> `gpt_state_dict_from_jax` -> the port: greedy f32 tokens
    (CFG 2.0, 12 tokens) equal JAX's."""
    params, _ = make_pair(TINY)
    jcfg = jax_config(TINY)
    if kind == "gptq-w4":
        labels, tokens = _calib()
        qp = jgptq.gptq_quantize_gpt_params(
            params, jcfg, jnp.asarray(labels), jnp.asarray(tokens),
            group_size=64, int8_head=True, compute_dtype=jnp.float32)
    else:
        qp = jquantize(params, quantize_head=True)
    sd = gpt_state_dict_from_jax(jax.tree.map(np.asarray, qp), TINY)
    model = gpt.Transformer(TINY)
    shape_quantized_linears(model, sd)
    model.load_state_dict(sd)
    lin = model.layers[1].feed_forward.w2
    assert (lin.weight_w4b if kind == "gptq-w4" else lin.weight_q) \
        .dtype == torch.int8 and model.output.weight_q is not None
    labels = np.array([3, 7])
    jtok = jgenerate(qp, jax.random.PRNGKey(0), jnp.asarray(labels),
                     cfg=jcfg, max_new_tokens=12, cfg_scale=2.0,
                     sample_logits=False, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32)
    tok = generate(model.eval(), torch.tensor(labels), max_new_tokens=12,
                   cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32, cache_dtype=torch.float32)
    assert len(np.unique(np.asarray(jtok))) > 3  # a real comparison
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_group_table_is_pack_w4s_layout():
    """The half-major segments (ragged tails at K/2 = 160, g64) and the
    per-channel table."""
    gid, starts, glen = gptq._group_table(320, 64, False)
    jgid, jstarts, jglen = jgptq._group_table(320, 64, False)
    np.testing.assert_array_equal(gid, jgid)
    np.testing.assert_array_equal(starts, jstarts)
    assert glen == jglen and starts.tolist() == [0, 64, 128, 160, 224, 288]
    gid, starts, glen = gptq._group_table(320, 64, True)
    assert not gid.any() and starts.tolist() == [0] and glen == 320
