"""Smoke test of the PyTorch + CUDA port (llamagen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (exit code != 0):

1. Build the CUDA kernels from `llamagen_tpu_torch/csrc` (nvcc, ctypes).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes: decode attention (K1) with bf16 and int8 caches, per-row
   positions, prefix padding and GQA; the W8A16 matmul (K2) at the GPT-L
   layer shapes and the int8 head. Each prints its max error beside its
   tolerance and its median time beside the plain version's (CUDA graphs
   of one call per layer, so the 24 layers' buffers stream from memory as
   they do in a step).
3. The main path: GPT-L 384 px, random seeded weights with a random head,
   W8A16 + int8 KV cache, batch 8 + CFG 2.0, 576 tokens, then the VQ-16
   decoder to [8, 384, 384, 3]. The kernels' launch counters must read
   exactly 24 * 575 (K1) and 5 * 24 * 576 (K2).
4. The CLI (`llamagen_tpu_torch.cli.sample_c2i`) once at GPT-L 384 with
   bf16 weights and cache, from a random checkpoint in a temp directory.
5. A teacher-forced comparison of kernels against plain versions over 64
   decode steps at GPT-L.
6. The training-attention kernels (K4: forward, dq, dk/dv) against their
   plain version (dense f32 scores, autograd) on the card: the GPT-L
   training shape [32, 576, 16, 64] bf16 (v a strided view, as the model
   gives it), [2, 577, 8, 128] f32 and bf16, head_dim 100 (padded to 128)
   and a ragged S = 257. Each prints its errors beside its tolerance; the
   GPT-L shape prints forward and forward + backward times beside the
   plain version's.
7. The training path: the CLI (`llamagen_tpu_torch.cli.train_c2i`) at
   GPT-L 384, batch 32, N synthetic steps with the default dropouts and
   full remat. The first loss must be ln 16384 (the zeroed head), every
   loss and grad norm finite, `metrics.jsonl` must hold steps 1..N and the
   final checkpoint must exist; the K4 counters must read 2 * 24 * N
   (forward: once in the step, once in the remat recompute) and 24 * N for
   each backward kernel. Prints step time, samples/s, tokens/s, peak
   memory and model-FLOP utilisation. Then 4 steps with remat "save_attn",
   where K4's forward runs once per layer and step.
8. One full training step at GPT-L (random head, dropout off) with K4 and
   with its plain version on the same weights and batch, in bf16 and in
   f32 compute: the loss difference and each parameter's relative
   gradient difference against stated bounds.

Comparisons run in bf16 (K4 also f32) with TF32 off for matmuls and
convolutions. The
last line is `{"ok": true, "device": {...}}`; the line before it is the
kernels' JSON record. Needs a CUDA device; runs nothing without one.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BATCH, CFG_SCALE, TOKENS = 8, 2.0, 576
TRAIN_BATCH, TRAIN_STEPS = 32, 10
H100_BF16_FLOPS = 989e12  # dense, NVIDIA's data sheet (SXM, 700 W)
GPT_L_MATMULS = {"wqkv": (1024, 3072), "wo": (1024, 1024),
                 "w1": (1024, 2816), "w3": (1024, 2816), "w2": (2816, 1024)}


def log(msg):
    print(msg, flush=True)


def graph_ms(calls, reps=5):
    """Median ms per call of `calls` (zero-arg callables, one per layer),
    captured in one CUDA graph and replayed, so no host overhead counts."""
    for fn in calls:  # warm up (allocator, first launches) outside capture
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_state(dev, b, h, h_kv, s, cache, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f_kv = h_kv * 64
    bf = torch.bfloat16
    q = torch.randn(b, h * 64, generator=g, device=dev).to(bf)
    kv_new = torch.randn(b, 2 * f_kv, generator=g, device=dev).to(bf)
    if cache == "bf16":
        kv = torch.randn(b, s, 2 * f_kv, generator=g, device=dev).to(bf)
        return q, kv_new, kv, {}
    kv = torch.randint(-127, 128, (b, s, 2 * f_kv), generator=g, device=dev,
                       dtype=torch.int8)
    extra = dict(
        kv_scale=(torch.rand(b, s, 2, generator=g, device=dev) * 0.02
                  + 1e-3).to(bf),
        tail=torch.randn(b, 32, 2 * f_kv, generator=g, device=dev).to(bf))
    return q, kv_new, kv, extra


def check_decode_attention(dev):
    from llamagen_tpu_torch.ops.attention import (decode_attention,
                                                  decode_attention_ref)
    b, h, s = 16, 16, 640
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(7)
    cases = ([("bf16", p, 16, None) for p in (1, 127, 128, 575)]
             + [("int8", p, 16, None) for p in (30, 31, 575)]
             + [("bf16", "per-row", 16, "pad"), ("int8", "per-row", 16, "pad"),
                ("bf16", 300, 4, None), ("int8", 415, 4, "pad")])
    for i, (cache, pos, h_kv, pad) in enumerate(cases):
        q, kv_new, kv, extra = attention_state(dev, b, h, h_kv, s, cache, i)
        if pos == "per-row":
            pos = torch.randint(1, 576, (b,), generator=g, device=dev,
                                dtype=torch.int32)
            pos[:4] = torch.tensor([31, 63, 64, 575], device=dev)
        pad_t = None
        if pad:  # masked left padding, never past the row's own position
            pad_t = torch.minimum(
                torch.randint(0, 40, (b,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.as_tensor(pos, dtype=torch.int32, device=dev))
        kv_ref = kv.clone()
        extra_ref = {k: v.clone() for k, v in extra.items()}
        out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad_t,
                               **extra)
        ref = decode_attention_ref(q, kv_new, kv_ref, pos, h,
                                   prefix_pad=pad_t, **extra_ref)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # bf16 output of f32 sums taken in another order: 4 bf16 ulps of
        # the largest output
        tol = 2 ** -6 * max(1.0, ref.float().abs().max().item())
        same = torch.equal(kv, kv_ref) and all(
            torch.equal(extra[k], extra_ref[k]) for k in extra)
        label = (f"K1 decode_attention {cache} cache, pos "
                 f"{'per-row' if torch.is_tensor(pos) else pos}, "
                 f"H/H_kv {h}/{h_kv}, prefix_pad {'yes' if pad else 'no'}")
        log(f"{label}: max_abs_err {err:.3g} (tol {tol:.3g}), "
            f"cache/scales/tail equal: {same}")
        if not (err <= tol and same):
            raise AssertionError(f"{label} disagrees with the plain version")
        worst = max(worst, err)

    # time at the mean decode position of the main path, one buffer set
    # per layer (24) as in a step
    timings = {}
    for cache in ("bf16", "int8"):
        states = [attention_state(dev, b, h, h, s, cache, 100 + l)
                  for l in range(24)]
        pos = 288
        ms = graph_ms([lambda st=st: decode_attention(st[0], st[1], st[2],
                                                      pos, h, **st[3])
                       for st in states])
        plain = graph_ms([lambda st=st: decode_attention_ref(
            st[0], st[1], st[2], pos, h, **st[3]) for st in states])
        timings[cache] = (ms, plain)
        log(f"K1 time, {cache} cache, B {b}, H {h}, pos {pos}, S {s}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return worst, timings


def check_int8_matmul(dev):
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     int8_matmul_ref,
                                                     quantize_weight)
    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    timings = {}
    shapes = dict(GPT_L_MATMULS, head=(1024, 16384))
    for name, (k, n) in shapes.items():
        w_q, w_s = quantize_weight(
            torch.randn(k, n, generator=g, device=dev) * 0.02)
        for b in (16, 1):
            x = torch.randn(b, k, generator=g, device=dev).to(torch.bfloat16)
            out = int8_matmul(x, w_q, w_s)
            ref = int8_matmul_ref(x, w_q, w_s)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            # one bf16 rounding of f32 sums taken in another order: 1 ulp
            # of the largest output
            tol = 2 ** -7 * ref.float().abs().max().item()
            log(f"K2 int8_matmul {name} [{b},{k}]x[{k},{n}]: max_abs_err "
                f"{err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"K2 {name} B={b} disagrees")
            worst = max(worst, err)
    for name, (k, n) in GPT_L_MATMULS.items():
        layers = [quantize_weight(torch.randn(k, n, generator=g, device=dev)
                                  * 0.02) for _ in range(24)]
        x = torch.randn(16, k, generator=g, device=dev).to(torch.bfloat16)
        w_bf16 = [(wq.float() * ws).to(torch.bfloat16) for wq, ws in layers]
        ms = graph_ms([lambda w=w: int8_matmul(x, *w) for w in layers])
        plain = graph_ms([lambda w=w: int8_matmul_ref(x, *w) for w in layers])
        bf16 = graph_ms([lambda w=w: x @ w for w in w_bf16])
        gbs = k * n / (ms * 1e-3) / 1e9
        timings[name] = (ms, plain)
        log(f"K2 time {name} [16,{k}]x[{k},{n}]: kernel {ms:.4f} ms "
            f"({gbs:.0f} GB/s of int8 weights), plain {plain:.4f} ms, "
            f"bf16 torch.matmul {bf16:.4f} ms")
    return worst, timings


# ---------------------------------------------------------------------------
# Phases 3-5: the main path, the CLI, teacher forcing
# ---------------------------------------------------------------------------


def gpt_l(dev, seed=0):
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    cfg = gpt_config("GPT-L", block_size=576, cls_token_num=1)
    model = gpt.init_weights(
        gpt.Transformer(cfg, device=dev, dtype=torch.bfloat16), seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=g)
    return model.eval()


def run_main_path(dev):
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    model = quantize_gpt_params(gpt_l(dev))
    labels = torch.arange(BATCH, device=dev) * 100 % 1000
    kw = dict(cfg_scale=CFG_SCALE, compute_dtype=torch.bfloat16,
              cache_dtype=torch.int8)
    gen = torch.Generator(device=dev).manual_seed(0)
    generate(model, labels, max_new_tokens=40, generator=gen, **kw)  # warm
    torch.cuda.synchronize()

    decode_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.time()
    tokens = generate(model, labels, max_new_tokens=TOKENS, generator=gen,
                      **kw)
    torch.cuda.synchronize()
    secs = time.time() - t0
    k1, k2 = decode_attention.launches, int8_matmul.launches
    log(f"main path (GPT-L 384, W8A16 + int8 KV, batch {BATCH} + CFG "
        f"{CFG_SCALE}): {TOKENS} tokens in {secs:.3f} s = "
        f"{BATCH / secs:.3f} img/s, {1e3 * secs / TOKENS:.3f} ms/token step; "
        f"launches decode_attention {k1}, int8_matmul {k2}")
    n_layer = model.cfg.n_layer
    if k1 != n_layer * (TOKENS - 1) or k2 != 5 * n_layer * TOKENS:
        raise AssertionError(f"launch counts {k1}, {k2}: expected "
                             f"{n_layer * (TOKENS - 1)}, {5 * n_layer * TOKENS}")
    if tokens.shape != (BATCH, TOKENS) or tokens.min() < 0 \
            or tokens.max() >= model.cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape}")

    vq_model = vq.init_weights(vq.VQModel(vq_config("VQ-16"), device=dev,
                                          dtype=torch.bfloat16))
    t0 = time.time()
    imgs = vq_model.decode_code(tokens.reshape(BATCH, 24, 24))
    torch.cuda.synchronize()
    log(f"VQ-16 decode_code -> {tuple(imgs.shape)} in {time.time() - t0:.3f} s")
    if imgs.shape != (BATCH, 384, 384, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("VQ images are not finite [8, 384, 384, 3]")
    return {"decode_attention": k1, "int8_matmul": k2}


def run_cli(dev):
    from llamagen_tpu_torch.cli import sample_c2i
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gpt_l_random.pt")
        torch.save(gpt_l(dev, seed=3).state_dict(), ckpt)
        out = os.path.join(tmp, "grid.png")
        t0 = time.time()
        res = sample_c2i.main([
            "--gpt-model", "GPT-L", "--gpt-ckpt", ckpt, "--image-size", "384",
            "--cfg-scale", str(CFG_SCALE), "--precision", "bf16",
            "--device", "cuda", "--out", out])
        secs = time.time() - t0
        png_ok = os.path.getsize(out) > 0
    n = res.images.shape[0]
    log(f"CLI sample_c2i (GPT-L 384, bf16 weights + cache, {n} images + "
        f"CFG): sampling {res.gen_seconds:.3f} s = {n / res.gen_seconds:.3f} "
        f"img/s, {1e3 * res.gen_seconds / TOKENS:.3f} ms/token step; whole "
        f"CLI {secs:.3f} s")
    import numpy as np
    if res.images.shape != (8, 384, 384, 3) \
            or not np.isfinite(res.images).all() or not png_ok \
            or res.tokens.min() < 0 or res.tokens.max() >= 16384:
        raise AssertionError("CLI output is not 8 finite 384 px images")


def run_teacher_forced(dev):
    """Kernels vs plain versions inside the model: same token inputs, 64
    decode steps, max |logit difference|."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import attention, quant_matmul
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    bound = 0.25  # bf16 rounding noise through 24 layers, logits std ~0.6
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, 16384, (64, 2 * BATCH), generator=g, device=dev)
    labels = torch.arange(2 * BATCH, device=dev) * 61 % 1000
    worst = {}
    for name, quant, cache_dtype in (("bf16", False, torch.bfloat16),
                                     ("W8A16 + int8 KV", True, torch.int8)):
        model = gpt_l(dev, seed=9)
        if quant:
            quantize_gpt_params(model)
        runs = []
        for plain in (False, True):
            saved = (gpt.decode_attention, quant_matmul.int8_matmul)
            if plain:
                gpt.decode_attention = attention.decode_attention_ref
                quant_matmul.int8_matmul = quant_matmul.int8_matmul_ref
            try:
                runs.append(_forced_logits(model, labels, toks, cache_dtype))
            finally:
                gpt.decode_attention, quant_matmul.int8_matmul = saved
        diff = max(max_err(a, b) for a, b in zip(*runs))
        agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                    for a, b in zip(*runs)) / len(runs[0])
        log(f"teacher-forced GPT-L {name}, 64 steps: max |logit kernel - "
            f"plain| {diff:.4g} (bound {bound}), argmax agreement "
            f"{agree:.4f}")
        if not diff <= bound:
            raise AssertionError(f"teacher-forced {name} exceeds its bound")
        worst[name] = diff
    return worst


def _forced_logits(model, labels, toks, cache_dtype):
    from llamagen_tpu_torch.config import find_multiple
    from llamagen_tpu_torch.models import gpt
    cfg = model.cfg
    dev = labels.device
    max_seq = find_multiple(1 + TOKENS, 128)
    b = labels.shape[0]
    if cache_dtype == torch.int8:
        stage = gpt.init_cache(cfg, b, 40, torch.bfloat16, dev)
        gpt.prefill(model, labels, stage)
        cache = gpt.quantize_cache(stage, cfg, max_seq)
        cache.tail = [c[:, :32].clone() for c in stage.kv]
    else:
        cache = gpt.init_cache(cfg, b, max_seq, cache_dtype, dev)
        gpt.prefill(model, labels, cache)
    return [gpt.decode_step(model, tok, 1 + i, cache)
            for i, tok in enumerate(toks)]


# ---------------------------------------------------------------------------
# Phases 6-8: training attention (K4), the training CLI, one step vs plain
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps=5):
    """Median ms of `fn()` over `reps` runs after one warm-up, CUDA
    events around each run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(dev, shape, dtype, seed, strided_v=True):
    """q, k, v and an output gradient w; v strided as in the model (a view
    into the [B, S, 3F] wqkv output)."""
    b, s, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, w = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for _ in range(3))
    if strided_v:
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev).to(dtype)
        v = qkv[..., 2 * h * d:].reshape(shape)
    else:
        v = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q, k, v, w


def attention_grads(fn, q, k, v, w):
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs, q.shape[-1] ** -0.5)
    out.backward(w)
    return [out.detach()] + [x.grad for x in xs]


def check_train_attention(dev):
    """K4 against its plain version. Errors are relative to the largest
    reference magnitude of each tensor: f32 1e-5 (sums in another order);
    bf16 1e-2 for o (1-2 bf16 ulps of the largest output) and 2e-2 for
    dq/dk/dv (p and ds are rounded to bf16 at other points: the kernel
    rounds ds as the TPU kernel does, the plain version's autograd rounds
    dp; delta = rowsum(do * o) carries o's rounding)."""
    from llamagen_tpu_torch.ops import train_attention as ta
    gpt_l_shape = (TRAIN_BATCH, TOKENS, 16, 64)
    cases = [(gpt_l_shape, torch.bfloat16, True),
             ((2, 577, 8, 128), torch.float32, True),
             ((2, 577, 8, 128), torch.bfloat16, False),
             ((2, 577, 8, 100), torch.bfloat16, False),
             ((4, 257, 12, 64), torch.bfloat16, True)]
    abs_err = {}
    for i, (shape, dtype, strided) in enumerate(cases):
        q, k, v, w = attention_inputs(dev, shape, dtype, 20 + i, strided)
        got = attention_grads(ta.causal_attention_padded, q, k, v, w)
        ref = attention_grads(ta.causal_attention_ref, q, k, v, w)
        torch.cuda.synchronize()
        rel = [max_err(a, r) / max(r.float().abs().max().item(), 1.0)
               for a, r in zip(got, ref)]
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        log(f"K4 causal_attention {list(shape)} {str(dtype)[6:]}"
            f"{' (v strided)' if strided else ''}: relative max err o "
            f"{rel[0]:.3g} (tol {tol:g}), dq {rel[1]:.3g}, dk {rel[2]:.3g}, "
            f"dv {rel[3]:.3g} (tol {2 * tol:g})")
        if not (rel[0] <= tol and max(rel[1:]) <= 2 * tol):
            raise AssertionError(f"K4 {shape} {dtype} disagrees")
        if shape == gpt_l_shape:
            abs_err = {"fwd": max_err(got[0], ref[0]),
                       "dq": max_err(got[1], ref[1]),
                       "dkdv": max(max_err(got[2], ref[2]),
                                   max_err(got[3], ref[3]))}
        del got, ref

    # times at the GPT-L training shape (one layer's call)
    q, k, v, w = attention_inputs(dev, gpt_l_shape, torch.bfloat16, 30)
    scale = 64 ** -0.5
    t = {}
    with torch.no_grad():
        t["fwd"] = cuda_ms(lambda: ta.train_attention_fwd(q, k, v, scale))
        t["plain_fwd"] = cuda_ms(
            lambda: ta.causal_attention_ref(q, k, v, scale))
        o, lse = ta.train_attention_fwd(q, k, v, scale)
        do = w.contiguous()
        t["dq"] = cuda_ms(lambda: ta.train_attention_dq(q, k, v, o, do, lse,
                                                        scale))
        _, delta = ta.train_attention_dq(q, k, v, o, do, lse, scale)
        t["dkdv"] = cuda_ms(lambda: ta.train_attention_dkdv(
            q, k, v, do, lse, delta, scale))
    t["fwd_bwd"] = cuda_ms(lambda: attention_grads(
        ta.causal_attention, q, k, v, w))
    t["plain_fwd_bwd"] = cuda_ms(lambda: attention_grads(
        ta.causal_attention_ref, q, k, v, w))
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = ta.causal_attention_ref(*xs, scale)
    t["plain_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        out, xs, w, retain_graph=True))
    flop = 2 * 2 * TRAIN_BATCH * 16 * TOKENS * (TOKENS + 1) / 2 * 64
    log(f"K4 time, GPT-L training shape {list(gpt_l_shape)} bf16, per layer:"
        f" forward {t['fwd']:.3f} ms (plain {t['plain_fwd']:.3f}), "
        f"dq {t['dq']:.3f} ms, dk/dv {t['dkdv']:.3f} ms (plain backward "
        f"{t['plain_bwd']:.3f}), forward + backward {t['fwd_bwd']:.3f} ms "
        f"(plain {t['plain_fwd_bwd']:.3f}); causal QK^T + PV "
        f"{flop / 1e9:.1f} GFLOP = {flop / t['fwd'] / 1e9:.1f} TFLOP/s of "
        f"useful forward work")
    return abs_err, t


def run_train_cli(dev, remat="full", steps=TRAIN_STEPS):
    """The training path through its CLI at GPT-L 384, batch 32. Under
    remat "full" K4's forward runs twice per layer and step (the step and
    the recompute), under "save_attn" once."""
    import numpy as np
    from llamagen_tpu_torch.cli import train_c2i
    from llamagen_tpu_torch.ops import train_attention as ta
    kernels = (ta.train_attention_fwd, ta.train_attention_dq,
               ta.train_attention_dkdv)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        for f in kernels:
            f.launches = 0
        t0 = time.time()
        state = train_c2i.main([
            "--gpt-model", "GPT-L", "--image-size", "384",
            "--global-batch-size", str(TRAIN_BATCH),
            "--synthetic-steps", str(steps), "--log-every", "1",
            "--ckpt-every", "100000", "--results-dir", tmp,
            "--remat", remat, "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = {f.__name__: f.launches for f in kernels}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        recs = [json.loads(line)
                for line in open(os.path.join(tmp, "metrics.jsonl"))]
        recs = [r for r in recs if "loss" in r]
        ckpt = os.path.join(tmp, "checkpoints", f"step_{steps:08d}.pt")
        ckpt_gb = os.path.getsize(ckpt) / 1e9 if os.path.exists(ckpt) else 0
        n_params = sum(p.numel() for p in state.model.parameters())
        n_layer = state.model.cfg.n_layer
        del state
    step_s = statistics.median(1 / r["steps_per_sec"] for r in recs[2:])
    tokens = TRAIN_BATCH * TOKENS
    mfu = 6 * n_params * tokens / step_s / H100_BF16_FLOPS
    losses = [r["loss"] for r in recs]
    log(f"training CLI (GPT-L 384, batch {TRAIN_BATCH}, {steps} steps, "
        f"bf16 compute, f32 master weights, AdamW + EMA, remat {remat}, "
        f"default dropouts): {secs:.1f} s in all; median step after warm-up "
        f"{step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s = "
        f"{tokens / step_s:.0f} tokens/s; peak memory {peak:.2f} GiB; "
        f"MFU {100 * mfu:.2f} % (6 * {n_params / 1e6:.1f}M params * tokens "
        f"/ step time / 989 TFLOP/s); final checkpoint {ckpt_gb:.2f} GB")
    log(f"training losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs]}; K4 launches "
        f"{launches}")
    if abs(losses[0] - math.log(16384)) > 1e-3:
        raise AssertionError(f"first loss {losses[0]} is not ln 16384")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs):
        raise AssertionError("a loss or grad norm is not finite")
    if [r["step"] for r in recs] != list(range(1, steps + 1)) \
            or ckpt_gb == 0:
        raise AssertionError("metrics.jsonl or the checkpoint is incomplete")
    fwd_per_step = 2 if remat == "full" else 1
    want = {"train_attention_fwd": fwd_per_step * n_layer * steps,
            "train_attention_dq": n_layer * steps,
            "train_attention_dkdv": n_layer * steps}
    if launches != want:
        raise AssertionError(f"K4 launches {launches}, expected {want}")
    return launches, {"step_s": step_s, "peak_gib": peak, "mfu": mfu}


def run_train_step_vs_plain(dev):
    """One full training step (loss, backward, clip, AdamW, EMA) at GPT-L
    with K4 and with its plain version, on the same weights and batch,
    dropout off, in bf16 and in f32 compute. Bounds, bf16: |loss
    difference| <= 1e-2 (logits carry ~2^-8 relative rounding, averaged
    over 18k tokens) and each parameter's ||g_kernel - g_plain|| /
    ||g_plain|| <= 5e-2 (the two attentions round p and ds at other
    points, and that noise passes through 24 bf16 layers); f32: 1e-4 and
    1e-3 (f32 sums in another order through 24 layers)."""
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import train_attention as ta
    from llamagen_tpu_torch.train import c2i
    from llamagen_tpu_torch.train.train_state import (Optimizer,
                                                      init_train_state)
    cfg = gpt_config("GPT-L", block_size=TOKENS, cls_token_num=1,
                     class_dropout_prob=0.0, token_dropout_p=0.0,
                     resid_dropout_p=0.0, ffn_dropout_p=0.0)
    g = torch.Generator(device=dev).manual_seed(41)
    batch = c2i.Batch(
        labels=torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                             device=dev),
        tokens=torch.randint(0, 16384, (TRAIN_BATCH, TOKENS), generator=g,
                             device=dev))
    worst = {}
    for dtype, (loss_bound, grad_bound) in ((torch.bfloat16, (1e-2, 5e-2)),
                                            (torch.float32, (1e-4, 1e-3))):
        runs = []
        for plain in (False, True):
            model = gpt.init_weights(gpt.Transformer(cfg, device=dev), seed=5)
            with torch.no_grad():  # a random head: every layer gets grads
                model.output.weight.normal_(0.0, 0.02, generator=torch
                                            .Generator(device=dev)
                                            .manual_seed(6))
            state = init_train_state(model, Optimizer(model), use_ema=True)
            step_fn = c2i.make_train_step(compute_dtype=dtype)
            saved = gpt.causal_attention_padded
            if plain:
                gpt.causal_attention_padded = ta.causal_attention_ref
            try:
                t0 = time.time()
                state, m = step_fn(state, batch, 0)
                torch.cuda.synchronize()
                secs = time.time() - t0
            finally:
                gpt.causal_attention_padded = saved
            runs.append((m["loss"].item(), m["grad_norm"].item(), secs,
                         {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()}))
            del state, model, step_fn
        (lk, nk, sk, gk), (lp, np_, sp, gp) = runs
        rel = {n: ((gk[n].float() - gp[n].float()).norm()
                   / gp[n].float().norm().clamp_min(1e-30)).item()
               for n in gp}
        name = max(rel, key=rel.get)
        log(f"one GPT-L training step, {str(dtype)[6:]} compute, K4 vs plain "
            f"attention (dropout off): loss {lk:.6f} vs {lp:.6f} (|diff| "
            f"{abs(lk - lp):.3g}, bound {loss_bound:g}), grad norm {nk:.6f} "
            f"vs {np_:.6f}; worst relative gradient difference "
            f"{rel[name]:.3g} ({name}, bound {grad_bound:g}), median "
            f"{statistics.median(rel.values()):.3g}; first-step wall time "
            f"{sk:.2f} s vs {sp:.2f} s")
        if not (abs(lk - lp) <= loss_bound and rel[name] <= grad_bound):
            raise AssertionError(f"the {dtype} training step with K4 "
                                 f"disagrees with the plain version")
        worst[dtype] = (abs(lk - lp), rel[name])
        del runs, gk, gp
    return worst


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    from llamagen_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    lib = _build.build()
    _build.load_library()
    log(f"kernel build: {time.time() - t0:.1f} s ({lib.name})")

    phases = {}

    def phase(name, fn):
        t = time.time()
        out = fn(dev)
        phases[name] = round(time.time() - t, 1)
        log(f"phase {name}: {phases[name]} s")
        return out

    k1_err, k1_t = phase("K1 checks", check_decode_attention)
    k2_err, k2_t = phase("K2 checks", check_int8_matmul)
    launches = phase("sampling main path", run_main_path)
    phase("sampling CLI", run_cli)
    phase("teacher forcing", run_teacher_forced)
    k4_err, k4_t = phase("K4 checks", check_train_attention)
    k4_launches, _ = phase("training CLI", run_train_cli)
    phase("training CLI, remat save_attn",
          lambda d: run_train_cli(d, "save_attn", 4))
    phase("training step vs plain", run_train_step_vs_plain)
    log(f"phase seconds: {phases}")

    k4 = "llamagen_tpu_torch/csrc/train_attention.cu"
    record = {"kernels": [
        {"name": "decode_attention", "route": "cuda",
         "source": "llamagen_tpu_torch/csrc/decode_attention.cu",
         "replaces": "llamagen_tpu/ops/attention.py:569",
         "launches": launches["decode_attention"], "max_abs_err": k1_err,
         "ms": k1_t["int8"][0], "plain_ms": k1_t["int8"][1]},
        {"name": "int8_matmul", "route": "cuda",
         "source": "llamagen_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "llamagen_tpu/ops/quant_matmul.py:62",
         "launches": launches["int8_matmul"], "max_abs_err": k2_err,
         "ms": k2_t["wqkv"][0], "plain_ms": k2_t["wqkv"][1]},
        # K4: the plain version has no separate dq and dk/dv passes, so
        # both backward kernels stand beside the whole plain backward
        {"name": "train_attention_fwd", "route": "cuda", "source": k4,
         "replaces": "llamagen_tpu/ops/train_attention.py:195",
         "launches": k4_launches["train_attention_fwd"],
         "max_abs_err": k4_err["fwd"], "ms": k4_t["fwd"],
         "plain_ms": k4_t["plain_fwd"]},
        {"name": "train_attention_dq", "route": "cuda", "source": k4,
         "replaces": "llamagen_tpu/ops/train_attention.py:213",
         "launches": k4_launches["train_attention_dq"],
         "max_abs_err": k4_err["dq"], "ms": k4_t["dq"],
         "plain_ms": k4_t["plain_bwd"]},
        {"name": "train_attention_dkdv", "route": "cuda", "source": k4,
         "replaces": "llamagen_tpu/ops/train_attention.py:213",
         "launches": k4_launches["train_attention_dkdv"],
         "max_abs_err": k4_err["dkdv"], "ms": k4_t["dkdv"],
         "plain_ms": k4_t["plain_bwd"]},
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
