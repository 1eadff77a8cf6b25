"""The plain reference of LlamaGen's GPT (upstream `autoregressive/models/
gpt.py`): float32 PyTorch, TF32 off, no kernels, no cache, no batching of
slots. It imports nothing of the program and takes nothing the program
made: the benchmark hands it the weights and inputs it handed the
program, and it quantises the weights and the cache rows itself.

- `serve_logits`: the CFG-mixed logits a served image's tokens were
  sampled from, by one full forward over the condition and the served
  tokens (teacher forcing), with the serving configuration's W8A16
  weights (per-output-channel int8, scale max|w| / 127) and int8 KV
  cache (rows below 32 * (pos // 32) of a decode step read back from
  per-row int8 with bf16 row scales, newer rows exact; the condition
  prefill attends to exact rows). `weight_bits=4` is the control.
- `train_steps`: the first steps of training (bf16 compute over f32
  masters is the configuration; here everything is f32): loss, backward,
  the global-norm clip, AdamW, with the dropout masks of the
  configuration's stream (below). `fp8_linear=True` is the control: every
  linear layer's inputs rounded to float8 e4m3 (per-tensor scale).

Dropout stream (the training configuration's): step s of seed n draws
`n_layer + 2` seeds from a CPU generator seeded `n * 1_000_003 + s`; seed
0 seeds a device generator for the class (caption) dropout draw of shape
[B], seed 1 one for the token dropout mask of the embeddings [B, S, D],
seed 2 + l one for layer l's residual mask and then its FFN mask (both
[B, S, D]); a mask keeps where uniform < 1 - p and scales by 1 / (1 - p).

Departure, for numbers only: under t2i left padding the leading all-zero
caption rows stay exactly zero in every layer and add nothing to any
gradient, but their own activation gradient overflows float32 through
the RMSNorms at depth; the reference stops the gradient at those rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

TAIL = 32  # exact rows of an int8 cache: [32 * (pos // 32), pos]
LINEAR_SUFFIXES = ("attention.wqkv.weight", "attention.wo.weight",
                   "feed_forward.w1.weight", "feed_forward.w2.weight",
                   "feed_forward.w3.weight")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def freqs_2d(c: Dict) -> torch.Tensor:
    """Upstream's 2D RoPE table [cls + grid**2, head_dim // 2, 2]: half the
    dimensions rotate with the row, half with the column; zero rows for the
    condition positions."""
    grid = int(round(c["block_size"] ** 0.5))
    half = c["head_dim"] // 2
    base = c.get("rope_base", 10000.0)
    fr = 1.0 / (base ** (np.arange(0, half, 2)[: half // 2] / half))
    t = np.outer(np.arange(grid), fr)
    fx = np.broadcast_to(t[:, None, :], (grid, grid, t.shape[1]))
    fy = np.broadcast_to(t[None, :, :], (grid, grid, t.shape[1]))
    g = np.concatenate([fx, fy], axis=-1).reshape(grid * grid, half)
    table = np.stack([np.cos(g), np.sin(g)], axis=-1)
    cond = np.zeros((c["cls_token_num"], half, 2))
    return torch.tensor(np.concatenate([cond, table]), dtype=torch.float32)


def rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D], freqs [S, D // 2, 2]: rotate interleaved pairs."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    cos, sin = freqs[None, :, None, :, 0], freqs[None, :, None, :, 1]
    return torch.stack([xr[..., 0] * cos - xr[..., 1] * sin,
                        xr[..., 1] * cos + xr[..., 0] * sin],
                       dim=-1).reshape(x.shape)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w [N, K] -> its symmetric per-output-channel quantisation, read
    back in f32: scale = max|row| / qmax + 1e-12, round half to even,
    levels in [-127, 127] (8 bits) or [-8, 7] (4 bits)."""
    qmax, lo = (127.0, -127.0) if bits == 8 else (7.0, -8.0)
    w = w.float()
    scale = w.abs().amax(dim=1, keepdim=True) / qmax + 1e-12
    return torch.clamp(torch.round(w / scale), lo, qmax) * scale


def quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row int8 of a cache row [..., F] read back in f32: scale =
    max|row| / 127 + 1e-8, the scale stored in bf16."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale.to(torch.bfloat16).float()


def _attention(q, k, v, allow, use_q=None, kq=None, vq=None):
    """q [B, S, H, D]; k, v [B, S, H, D]; allow [B, 1 or H, S, S] bool.
    With `use_q` [S, S] (query, key), those keys read their int8 copies
    `kq`, `vq`."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if use_q is not None:
        s = torch.where(use_q, torch.einsum("bqhd,bkhd->bhqk", q, kq) * scale,
                        s)
    p = torch.softmax(s.masked_fill(~allow, -math.inf), dim=-1)
    if use_q is None:
        return torch.einsum("bhqk,bkhd->bqhd", p, v)
    return (torch.einsum("bhqk,bkhd->bqhd", p * use_q, vq)
            + torch.einsum("bhqk,bkhd->bqhd", p * ~use_q, v))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _embed_condition(w, c, cond):
    """Labels [N] -> [N, 1, D]; caption features [N, T, C] -> [N, T, D]."""
    if c["model_type"] == "c2i":
        return w["cls_embedding.embedding_table.weight"][cond][:, None]
    h = F.gelu(cond @ w["cls_embedding.cap_proj.fc1.weight"].t(),
               approximate="tanh")
    return (h @ w["cls_embedding.cap_proj.fc2.weight"].t())[
        :, :c["cls_token_num"]]


@torch.no_grad()
def serve_logits(weights: Dict[str, torch.Tensor], c: Dict,
                 cond: torch.Tensor, tokens: torch.Tensor, cfg_scale: float,
                 pads: Optional[torch.Tensor] = None, weight_bits: int = 8,
                 block: int = 2) -> torch.Tensor:
    """[N, T, V] f32: position i's CFG-mixed logits (uncond + (cond -
    uncond) * cfg_scale), from which token i was drawn, given the served
    tokens [N, T]. cond: labels [N] (c2i) or captions [N, T_c, C] (t2i,
    left-padded by `pads` [N] rows, which are zero); blocks of `block`
    sequences at a time."""
    no_tf32()
    dev = tokens.device
    w = {k: (quant_weight(v, weight_bits)
             if k.endswith(LINEAR_SUFFIXES) or k == "output.weight"
             else v.float()) for k, v in weights.items()}
    cls, t = c["cls_token_num"], tokens.shape[1]
    s_len = cls + t - 1
    freqs = freqs_2d(c)[:s_len].to(dev)
    rows = torch.arange(s_len, device=dev)
    # the int8 cache: decode positions read keys below 32 * (pos // 32)
    # from int8 rows; the t2i condition prefill attends to exact rows
    first_decode = cls if c["model_type"] == "t2i" else 0
    bnd = torch.where(rows >= first_decode, rows // TAIL * TAIL, 0)
    use_q = rows[None, :] < bnd[:, None]
    causal = rows[None, :] <= rows[:, None]
    out = []
    for at in range(0, tokens.shape[0], block):
        tok = tokens[at:at + block]
        n = tok.shape[0]
        if c["model_type"] == "c2i":
            lab = cond[at:at + block]
            cnd = torch.cat([lab, torch.full_like(lab, c["num_classes"])])
            pad = torch.zeros(2 * n, dtype=torch.long, device=dev)
        else:
            cap = cond[at:at + block].float()
            null = w["cls_embedding.uncond_embedding"][None].expand_as(cap)
            cnd = torch.cat([cap, null])
            pad = torch.cat([pads[at:at + block]] * 2).long()
        tok_emb = w["tok_embeddings.weight"][tok[:, :-1]].repeat(2, 1, 1)
        h = torch.cat([_embed_condition(w, c, cnd), tok_emb], dim=1)
        valid_key = rows[None, :] >= pad[:, None]  # [2n, S]
        allow = causal[None] & (valid_key[:, None, :]
                                | torch.eye(s_len, dtype=torch.bool,
                                            device=dev)[None])
        allow = allow[:, None]
        h = _layers(w, c, h, freqs, allow, use_q=use_q)
        logits = rms(h[:, cls - 1:], w["norm.weight"], c["norm_eps"]) \
            @ w["output.weight"].t()
        cl, un = logits.chunk(2)
        out.append(un + (cl - un) * cfg_scale)
    return torch.cat(out)


def _layers(w, c, h, freqs, allow, use_q=None, masks=None, linear=None,
            remat=False, stop=None):
    """The layer loop. `masks(l, x)` applies layer l's dropout to the
    attention (call 0) then the FFN output (call 1); `linear(x, W)` is the
    matmul (f32 by default); `stop` [B, S, 1] bool rows whose gradient is
    stopped before every layer."""
    linear = linear or (lambda x, m: x @ m.t())
    hq, hk, d = c["n_head"], c["n_kv_head"], c["head_dim"]
    eps = c["norm_eps"]

    def layer(l, h):
        p = f"layers.{l}."
        x = rms(h, w[p + "attention_norm.weight"], eps)
        qkv = linear(x, w[p + "attention.wqkv.weight"])
        b, s = x.shape[:2]
        q = rope(qkv[..., :hq * d].reshape(b, s, hq, d), freqs)
        k = rope(qkv[..., hq * d:(hq + hk) * d].reshape(b, s, hk, d), freqs)
        v = qkv[..., (hq + hk) * d:].reshape(b, s, hk, d)
        kq = vq = None
        if use_q is not None:
            kq = quant_rows(k.reshape(b, s, hk * d)).reshape(k.shape)
            vq = quant_rows(v.reshape(b, s, hk * d)).reshape(v.shape)
        rep = hq // hk
        if rep > 1:
            k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
            if kq is not None:
                kq, vq = (t.repeat_interleave(rep, dim=2) for t in (kq, vq))
        a = _attention(q, k, v, allow, use_q, kq, vq).reshape(b, s, hq * d)
        a = linear(a, w[p + "attention.wo.weight"])
        if masks is not None:
            a = masks(l, a, 0)
        h = h + a
        x = rms(h, w[p + "ffn_norm.weight"], eps)
        f = linear(F.silu(linear(x, w[p + "feed_forward.w1.weight"]))
                   * linear(x, w[p + "feed_forward.w3.weight"]),
                   w[p + "feed_forward.w2.weight"])
        if masks is not None:
            f = masks(l, f, 1)
        return h + f

    for l in range(c["n_layer"]):
        if stop is not None:
            h = torch.where(stop, h.detach(), h)
        h = checkpoint(layer, l, h, use_reentrant=False) if remat \
            else layer(l, h)
    return h


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def step_seeds(seed: int, step: int, n_layer: int) -> List[int]:
    g = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return torch.randint(0, 2 ** 62, (n_layer + 2,), generator=g).tolist()


def _uniform(shape, seed: int, dev) -> torch.Tensor:
    return torch.rand(shape, generator=torch.Generator(device=dev)
                      .manual_seed(seed), device=dev)


def _keep(x, seed_or_gen, p):
    """Dropout of x with the next uniform draw of `seed_or_gen`."""
    u = torch.rand(x.shape, generator=seed_or_gen, device=x.device)
    return torch.where(u < 1 - p, x / (1 - p), torch.zeros_like(x))


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, gradient passed
    straight through."""
    s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (r - t.detach())


def train_loss(w: Dict[str, torch.Tensor], c: Dict, t: Dict, batch: Dict,
               seed: int, step: int, fp8_linear: bool = False
               ) -> torch.Tensor:
    """The loss of one training step's forward (f32, dropout on): batch
    holds `cond` (labels [B], or captions [B, T, C] with `masks` [B, T])
    and `tokens` [B, L] targets (and `valid` [B])."""
    dev = batch["tokens"].device
    seeds = step_seeds(seed, step, c["n_layer"])
    cond = batch["cond"]
    b = cond.shape[0]
    drop = _uniform((b,), seeds[0], dev) < c["class_dropout_prob"]
    if c["model_type"] == "c2i":
        cond_emb = _embed_condition(
            w, c, torch.where(drop, c["num_classes"], cond))
    else:
        cond = cond * batch["masks"][..., None].to(cond.dtype)
        cond = torch.where(drop[:, None, None],
                           w["cls_embedding.uncond_embedding"], cond)
        cond_emb = _embed_condition(w, c, cond)
    tokens = batch["tokens"]
    h = torch.cat([cond_emb, w["tok_embeddings.weight"][tokens[:, :-1]]], 1)
    g1 = torch.Generator(device=dev).manual_seed(seeds[1])
    h = _keep(h, g1, t["token_dropout_p"])
    s = h.shape[1]
    rows = torch.arange(s, device=dev)
    allow = (rows[None, :] <= rows[:, None])[None, None]
    stop = None
    if c["model_type"] == "t2i":
        zero = (cond_emb == 0).all(-1).int().cumprod(1).bool()
        stop = F.pad(zero, (0, s - zero.shape[1]))[..., None]
    gens = {}

    def masks(l, x, call):
        if call == 0:  # a fresh generator per layer call (recompute too)
            gens[l] = torch.Generator(device=dev).manual_seed(seeds[2 + l])
        p = t["resid_dropout_p"] if call == 0 else t["ffn_dropout_p"]
        return _keep(x, gens[l], p)

    linear = (lambda x, m: fp8(x) @ fp8(m).t()) if fp8_linear else None
    h = _layers(w, c, h, freqs_2d(c)[:s].to(dev), allow, masks=masks,
                linear=linear, remat=True, stop=stop)
    x = rms(h, w["norm.weight"], c["norm_eps"])
    logits = (linear or (lambda x, m: x @ m.t()))(x, w["output.weight"])
    logits = logits[:, c["cls_token_num"] - 1:]
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens.reshape(-1), reduction="none") \
        .reshape(tokens.shape)
    valid = batch.get("valid")
    if valid is None:
        return nll.mean()
    wgt = valid[:, None].float().expand_as(nll)
    return (nll * wgt).sum() / wgt.sum().clamp_min(1.0)


def decays(name: str) -> bool:
    return not ("norm" in name or "scale" in name or name.endswith("bias"))


def train_steps(weights: Dict[str, torch.Tensor], c: Dict, t: Dict,
                batches: List[Dict], seed: int, fp8_linear: bool = False
                ) -> Dict[str, object]:
    """len(batches) steps from `weights` (f32 masters): loss, backward,
    clip by the global norm (`max_grad_norm`), AdamW (`lr`, `betas`,
    `weight_decay` on all but norms, eps 1e-8) as the configuration's
    trainer `t` states. Returns the losses, the first step's global norm
    before the clip, each leaf's norm of the first gradient after the
    clip, and each leaf's norm of the change after the last step."""
    no_tf32()
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = t["betas"]
    lr, wd, clip = t["lr"], t["weight_decay"], t["max_grad_norm"]
    losses, grad_norm, first = [], None, None
    for i, batch in enumerate(batches):
        loss = train_loss(params, c, t, batch, seed, i, fp8_linear)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        norm = torch.sqrt(sum(g.double().pow(2).sum()
                              for g in grads.values())).float()
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        losses.append(float(loss))
        if i == 0:
            grad_norm = float(norm)
            first = {k: float(torch.linalg.vector_norm(g.double()))
                     for k, g in grads.items()}
        with torch.no_grad():
            n = i + 1
            for k, p in params.items():
                g = grads[k]
                if decays(k):
                    p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** n)).add_(1e-8)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** n))
    change = {k: float(torch.linalg.vector_norm((params[k] - start[k])
                                                .double()))
              for k in params}
    return {"losses": losses, "grad_norm": grad_norm, "grad_leaf": first,
            "change_leaf": change}
