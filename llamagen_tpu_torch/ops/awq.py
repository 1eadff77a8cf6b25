"""AWQ: activation-aware equalisation of a GPT before W4 quantisation.

PyTorch counterpart of `llamagen_tpu/ops/awq.py`. Int4 round-to-nearest
error is dominated by input channels whose activations are large. AWQ (Lin
et al. 2023, arXiv 2306.00978) scales each weight matrix's input channels
by s_k = mean|x_k|^alpha (alpha searched on a grid to minimise the
quantised layer's output error) and folds 1 / s into the op that produces
x, so the model computes the same function before quantisation and only
the int4 grid moves toward the salient channels.

Every fold is exact, with no extra op at run time. In the port's
`Linear.weight [out, in]` layout, "rows" of the JAX package's `[in, out]`
kernels are columns here:

    wqkv  columns * s  <-  attention_norm / s
    w1,w3 columns * s  <-  ffn_norm / s          (one s: a shared input)
    w2    columns * s  <-  w3's output rows / s  (silu(w1 x) * w3 x is
                                                  linear in w3's output)
    wo    columns * s  <-  the v rows of wqkv / s (an attention output
                                                  channel (h, d) is linear
                                                  in v channel (h // rep,
                                                  d): s is pooled over
                                                  each GQA group)

Calibration reuses GPTQ's teacher-forced pass (`ops/gptq.py`). The result
is an ordinary model of the same dtype, which round-to-nearest
(`ops/w4_matmul.py::quantize_gpt_params_w4k`) or GPTQ then quantises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.gptq import (_calib_stream, _group_table,
                                         _scale, layer_linears,
                                         layer_matmul_inputs)
from llamagen_tpu_torch.ops.w4_matmul import SEG_ROWS

DEFAULT_ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)


def _rtn_dequant(w: torch.Tensor, gid: torch.Tensor,
                 ngroups: int) -> torch.Tensor:
    """W [K, N] round-tripped through the W4 kernel's int4 grid (a group's
    max / 7 scale per column; `gid` [K] the rows' groups)."""
    a = w.abs()
    mx = torch.zeros(ngroups, w.shape[1], dtype=w.dtype, device=w.device) \
        .scatter_reduce_(0, gid[:, None].expand_as(a), a, reduce="amax",
                         include_self=False)
    sc = _scale(mx)[gid]
    return torch.clamp(torch.round(w / sc), -8, 7) * sc


def _fold_loss(xs: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
               gid: torch.Tensor, ngroups: int) -> torch.Tensor:
    """mean ((x / s) @ Q(s * W) - x @ W)^2 over the calibration rows."""
    dq = _rtn_dequant(w * s[:, None], gid, ngroups)
    return torch.mean(((xs / s[None, :]) @ dq - xs @ w) ** 2)


def _subsample(x: torch.Tensor, sample: int) -> torch.Tensor:
    """[B, S, K] -> at most `sample` rows [M, K] f32, taken at a fixed
    stride (deterministic)."""
    flat = x.reshape(-1, x.shape[-1]).float()
    n = flat.shape[0]
    if n <= sample:
        return flat
    return flat[::n // sample][:sample]


def _search_scale(x: torch.Tensor, ws: Sequence[torch.Tensor],
                  gid: torch.Tensor, ngroups: int, alphas: Sequence[float],
                  sample: int,
                  pool: Optional[Callable[[torch.Tensor], torch.Tensor]]
                  = None, rel_margin: float = 0.02
                  ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """The grid search of one fold point. x [B, S, K]: calibration inputs;
    ws: the [K, N] (input-major) weights that read x (their losses add:
    w1 and w3 share a fold); pool: a [K] -> [K] projection of the
    activation statistic onto the scales a fold can realise (the GQA
    pooling of the wo fold). Returns (s [K] f32, the loss of each alpha,
    the chosen alpha's index).

    alphas[0] must be 0.0 (s = 1, the plain grid); another alpha is taken
    only if it beats it by rel_margin of its loss: the search is local and
    greedy, and a marginal local win need not hold end to end."""
    if alphas[0] != 0.0:
        raise ValueError("the alpha grid must lead with 0.0 (identity)")
    xs = _subsample(x, sample)
    amean = xs.abs().mean(dim=0).clamp_min(1e-5)
    if pool is not None:
        amean = pool(amean)
    losses, cands = [], []
    for alpha in alphas:
        s = amean ** alpha
        # centre the range so that s and 1 / s stay bounded
        s = (s / torch.sqrt(s.max() * s.min())).clamp(1e-4, 1e4)
        losses.append(float(sum(_fold_loss(xs, w, s, gid, ngroups)
                                for w in ws)))
        cands.append(s)
    best = int(np.argmin(losses))
    if losses[best] >= losses[0] * (1.0 - rel_margin):
        best = 0
    return cands[best], np.asarray(losses), best


@torch.no_grad()
def awq_equalize_gpt_params(model: gpt.Transformer, cond: torch.Tensor,
                            tokens: torch.Tensor, *,
                            per_channel: bool = False,
                            group_size: int = SEG_ROWS,
                            alphas: Sequence[float] = DEFAULT_ALPHAS,
                            sample: int = 1024,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            verbose: bool = False
                            ) -> List[Dict[str, float]]:
    """Equalise a `Transformer` in place (the same function up to
    rounding; quantise it afterwards). cond / tokens: calibration labels
    or captions and ids, as `gptq_quantize_gpt_params` takes them;
    group_size / per_channel: the int4 grid the search optimises against
    (the mode the model will be quantised with). Returns each layer's
    chosen alphas {"wqkv", "ffn", "w2", "wo"}."""
    cfg = model.cfg
    h, freqs, mask = _calib_stream(model, cond, tokens[:, :-1],
                                   compute_dtype)
    rep, hd = cfg.n_head // cfg.kv_heads, cfg.head_dim
    v0 = (cfg.n_head + cfg.kv_heads) * hd  # wqkv's first v row

    def pool_kv(amean):
        """The statistic averaged over each GQA group, so that one v
        channel's divisor serves the rep query heads that read it."""
        g = amean.reshape(cfg.kv_heads, rep, hd)
        return g.mean(dim=1, keepdim=True).expand_as(g).reshape(-1)

    def table(k):
        gid, _, _ = _group_table(k, group_size, per_channel)
        return (torch.as_tensor(gid, dtype=torch.long, device=h.device),
                1 if per_channel else int(gid.max()) + 1)

    chosen = []
    for l, layer in enumerate(model.layers):
        inputs, h = layer_matmul_inputs(layer, h, freqs, mask, cfg)
        lin = layer_linears(layer)
        # input-major f32 copies, as the JAX package holds its kernels
        w = {key: m.weight.t().float() for key, m in lin.items()}
        gid_d, ng_d = table(cfg.dim)
        gid_f, ng_f = table(cfg.ffn_hidden_dim)
        s_qkv, _, a_qkv = _search_scale(inputs["wqkv"], [w["wqkv"]], gid_d,
                                        ng_d, alphas, sample)
        s_ffn, _, a_ffn = _search_scale(inputs["w1"], [w["w1"], w["w3"]],
                                        gid_d, ng_d, alphas, sample)
        s_w2, _, a_w2 = _search_scale(inputs["w2"], [w["w2"]], gid_f, ng_f,
                                      alphas, sample)
        s_wo, _, a_wo = _search_scale(inputs["wo"], [w["wo"]], gid_d, ng_d,
                                      alphas, sample, pool=pool_kv)
        del inputs
        # the v divisor lives in the kv domain: one value per (kv head, d)
        s_v = s_wo.reshape(cfg.kv_heads, rep, hd)[:, 0].reshape(-1)

        wqkv = w["wqkv"] * s_qkv[:, None]
        wqkv[:, v0:] = wqkv[:, v0:] / s_v[None, :]
        folded = {
            layer.attention_norm.weight:
                layer.attention_norm.weight.float() / s_qkv,
            layer.ffn_norm.weight: layer.ffn_norm.weight.float() / s_ffn,
            lin["wqkv"].weight: wqkv.t(),
            lin["wo"].weight: (w["wo"] * s_wo[:, None]).t(),
            lin["w1"].weight: (w["w1"] * s_ffn[:, None]).t(),
            lin["w3"].weight: ((w["w3"] * s_ffn[:, None]) / s_w2[None, :]).t(),
            lin["w2"].weight: (w["w2"] * s_w2[:, None]).t(),
        }
        for param, value in folded.items():
            param.copy_(value.to(param.dtype))
        chosen.append({"wqkv": alphas[a_qkv], "ffn": alphas[a_ffn],
                       "w2": alphas[a_w2], "wo": alphas[a_wo]})
        if verbose:
            print(f"awq: layer {l + 1}/{cfg.n_layer} alphas "
                  + " ".join(f"{k}={v}" for k, v in chosen[-1].items()),
                  flush=True)
    return chosen
