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

Comparisons run in bf16 with TF32 off for matmuls and convolutions. The
last line is `{"ok": true, "device": {...}}`; the line before it is the
kernels' JSON record. Needs a CUDA device; runs nothing without one.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

BATCH, CFG_SCALE, TOKENS = 8, 2.0, 576
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

    k1_err, k1_t = check_decode_attention(dev)
    k2_err, k2_t = check_int8_matmul(dev)
    launches = run_main_path(dev)
    run_cli(dev)
    run_teacher_forced(dev)

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
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
