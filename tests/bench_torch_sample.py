"""Where the time of the W8A16, W4 and speculative sampling paths goes, for
the PyTorch port on one GPU.

Not a pytest file:

    python tests/bench_torch_sample.py [out.json] [--w8a16-only]

GPT-L 384, random seeded weights with a random head, batch 8 + CFG:

- the W8A16 path (the `bench.py` operating point): W8A16 layer weights +
  int8 KV cache (prefilled, quantised, its tail seeded as `generate`
  does), the decode loop at positions 289..320;
- the W4 path: grouped W4 layer weights (`quantize_gpt_params_w4k`
  defaults) + bf16 KV, the decode loop of `ops/generate.py` (decode_step,
  cfg_mix 2.0, sample) at positions 289..320;
- the speculative path: the bf16 model as target, a W4 copy of it as draft,
  k 4, CFG 4.0, sampled, `generate_speculative` over 64 tokens.

Each is timed on the host clock (ending in a device sync), then traced with
`torch.profiler`; reported per decode step or per verify round: wall ms,
device busy ms (the union of kernel intervals, so overlapping kernels
count once), the idle share, kernels launched, and device ms by group
(the tensor-core attention kernel that K1 and K5 share, K1's CUDA-core
kernel, K2 W8A16 matmul, K3 W4 matmul, the separate insert and split-K
launches of earlier designs, cuBLAS, the rest). Then the host cost of one
wrapper call (`int8_matmul` and `w4_matmul` at wqkv B 16,
`decode_attention` on the int8 cache at pos 288, `chunk_decode_attention`
at C 5, pos 288): host µs per call over 2000 calls enqueued back to
back. Run it in a copy of an earlier tree too (copied into its `tests/`)
to compare trees, in alternating pairs.
`--w8a16-only` runs the W8A16 path alone (for paired runs of two trees).
`--t2i` runs the t2i sampling path alone: GPT-XL 512 px (120 caption
tokens, left pads 0, 60, 100 and 119, bf16 weights and cache), 4 captions
+ CFG 7.5, top-k 1000, the decode loop (`prefix_pad` in every layer) at
positions 632..663, the mean position of its 1,024 tokens.
Prints a JSON object as its last line (and writes it to `out.json` when
given). Needs a CUDA device.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch_train import _union_us  # noqa: E402


def _group(name: str) -> str:
    low = name.lower()
    if "insert_kernel" in low or "insert_flush" in low \
            or "finish_kernel" in low:
        return "K1/K2/K5 insert and split-K launches"
    for keys, group in ((("attn_mma", "chunk_mma"),
                         "K1/K5 tensor-core attention"),
                        (("decode_attn",), "K1 decode attention (CUDA cores)"),
                        (("int8_mma", "int8_matmul"), "K2 W8A16 matmul"),
                        (("w4_mma", "w4_matmul"), "K3 W4 matmul"),
                        (("chunk_attn",), "K5 chunk attention (CUDA cores)")):
        if any(k in low for k in keys):
            return group
    if "gemm" in low or "cutlass" in low or "xmma" in low \
            or low.startswith("nvjet"):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies, sampling)"


def _profile(fn):
    """Run fn() (which ends in a device sync and returns its count of
    units: steps or rounds) on the host clock, then again under
    `torch.profiler`; per unit: wall ms, device busy ms, idle share,
    kernels launched and device ms by group."""
    t0 = time.time()
    units = fn()
    wall = (time.time() - t0) / units * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        units = fn()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / 1e3 / units
    groups = {}
    for e in kernels:
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3 / units
    return {"units": units, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall, "kernels": len(kernels) / units,
            "device_ms_by_group": groups}


def _wrapper_host_us(w4_model, w8_model, cache, cache8, dev, calls=2000):
    """Host µs per wrapper call, enqueued back to back (the device work of
    a call is shorter than its host cost, so the queue never fills)."""
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import int8_matmul
    from llamagen_tpu_torch.ops.w4_matmul import w4_matmul
    lin = w4_model.layers[0].attention.wqkv
    lin8 = w8_model.layers[0].attention.wqkv
    x = torch.randn(16, lin.weight_w4b.shape[1] * 2, device=dev,
                    dtype=torch.bfloat16)
    q = torch.randn(16, 5, 1024, device=dev, dtype=torch.bfloat16)
    kv_new = torch.randn(16, 5, 2048, device=dev, dtype=torch.bfloat16)
    kv = cache.kv[0]
    # decode_attention at pos 288 (pos % 32 = 0: no flush) on a copy of
    # layer 0's int8 state, so the timed path's cache stays as it was
    kv8, sc8, tail8 = (t[0].clone() for t in (cache8.kv, cache8.kv_scale,
                                               cache8.tail))
    out = {}
    for name, fn in (("int8_matmul", lambda: int8_matmul(
                          x, lin8.weight_q, lin8.weight_scale)),
                     ("decode_attention", lambda: decode_attention(
                         q[:, 0], kv_new[:, 0], kv8, 288, 16, kv_scale=sc8,
                         tail=tail8)),
                     ("w4_matmul", lambda: w4_matmul(x, lin.weight_w4b,
                                                     lin.weight_w4s)),
                     ("chunk_decode_attention", lambda: chunk_decode_attention(
                         q, kv_new, kv, 288, 16))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def t2i_step_profile(dev):
    """The t2i sampling path's decode step (`--t2i`), profiled."""
    from chip_smoke import (T2I_CFG, T2I_PADS, T2I_TOP_K, t2i_captions,
                            t2i_model)
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import sampling
    from llamagen_tpu_torch.ops.generate import build_cfg_batch, caption_masks
    model = t2i_model(dev, 512)
    cfg = model.cfg
    caps, masks = t2i_captions(dev, T2I_PADS, seed=90)
    prefix_mask, prefix_pad = caption_masks(masks, 120, True)
    cache = gpt.init_cache(cfg, 8, 1152, torch.bfloat16, dev)
    gpt.prefill(model, build_cfg_batch(model, caps, True), cache,
                prefix_mask=prefix_mask)
    tok = torch.zeros(4, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def steps(n=32, pos0=632):
        nonlocal tok
        for i in range(n):
            logits = gpt.decode_step(model, torch.cat([tok, tok]), pos0 + i,
                                     cache, prefix_pad=prefix_pad)
            tok = sampling.sample(sampling.cfg_mix(logits, T2I_CFG), gen,
                                  top_k=T2I_TOP_K)
        torch.cuda.synchronize()
        return n

    steps(8, 600)  # warm-up
    return _profile(steps)


def main(argv):
    only_w8 = "--w8a16-only" in argv
    paths = [a for a in argv if not a.startswith("--")]
    out_path = paths[0] if paths else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from llamagen_tpu_torch.config import find_multiple, gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import sampling
    from llamagen_tpu_torch.ops.attention import TAIL
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if "--t2i" in argv:
        res = {"card": smi}
        r = res["t2i_step"] = t2i_step_profile(dev)
        print(f"t2i_step (GPT-XL 512, bf16, x{r['units']}): wall "
              f"{r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f}"
              f" ms (idle {100 * r['idle_share']:.1f} %), "
              f"{r['kernels']:.0f} kernels")
        for g, ms in sorted(r["device_ms_by_group"].items(),
                            key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {g}")
        if out_path:
            Path(out_path).parent.mkdir(parents=True, exist_ok=True)
            Path(out_path).write_text(json.dumps(res) + "\n")
        print(json.dumps(res))
        return
    cfg = gpt_config("GPT-L", block_size=576, cls_token_num=1)
    model = gpt.init_weights(gpt.Transformer(cfg, device=dev,
                                             dtype=torch.bfloat16), seed=0)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=torch.Generator(
            device=dev).manual_seed(1))
    model.eval()
    w4 = quantize_gpt_params_w4k(copy.deepcopy(model))
    w8 = quantize_gpt_params(copy.deepcopy(model))
    labels = torch.arange(8, device=dev) * 100 % 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"card": smi}

    # the W4 decode loop at positions 289..320 (the cache holds zeros
    # below: the work per step depends on the position only)
    cache = gpt.init_cache(cfg, 16, find_multiple(577, 128), torch.bfloat16,
                           dev)
    tok = torch.zeros(8, dtype=torch.long, device=dev)

    # the W8A16 decode loop on an int8 cache, set up as `generate` does
    stage = gpt.init_cache(cfg, 16, 40, torch.bfloat16, dev)
    gpt.prefill(w8, torch.cat([labels, torch.full_like(labels, 1000)]),
                stage)
    cache8 = gpt.quantize_cache(stage, cfg, find_multiple(577, 128))
    cache8.tail = [c[:, :TAIL].clone() for c in stage.kv]

    def w8_steps(n=32, pos0=289):
        nonlocal tok
        for i in range(n):
            logits = gpt.decode_step(w8, torch.cat([tok, tok]), pos0 + i,
                                     cache8)
            tok = sampling.sample(sampling.cfg_mix(logits, 2.0), gen)
        torch.cuda.synchronize()
        return n

    def w4_steps(n=32, pos0=289):
        nonlocal tok
        for i in range(n):
            logits = gpt.decode_step(w4, torch.cat([tok, tok]), pos0 + i,
                                     cache)
            tok = sampling.sample(sampling.cfg_mix(logits, 2.0), gen)
        torch.cuda.synchronize()
        return n

    def spec():  # returns its verify rounds
        _, rounds = generate_speculative(model, w4, labels,
                                         max_new_tokens=64, k=4,
                                         generator=gen, cfg_scale=4.0)
        torch.cuda.synchronize()
        return rounds

    w8_steps(8, 257)  # warm-up: kernel build, allocator, cuBLAS plans
    res["w8a16_int8kv_step"] = _profile(w8_steps)
    if not only_w8:
        w4_steps(8)
        res["w4_step"] = _profile(w4_steps)
        spec()
        res["spec_round"] = _profile(spec)
        res["host_us_per_call"] = _wrapper_host_us(w4, w8, cache, cache8,
                                                   dev)
    for path in ("w8a16_int8kv_step", "w4_step", "spec_round")[
            :1 if only_w8 else 3]:
        r = res[path]
        print(f"{path} (x{r['units']}): wall {r['wall_ms']:.2f} ms, device "
              f"busy {r['device_busy_ms']:.2f} ms (idle "
              f"{100 * r['idle_share']:.1f} %), {r['kernels']:.0f} kernels")
        for g, ms in sorted(r["device_ms_by_group"].items(),
                            key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {g}")
    if not only_w8:
        print(f"host us per wrapper call: {res['host_us_per_call']}")
    line = json.dumps(res)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
