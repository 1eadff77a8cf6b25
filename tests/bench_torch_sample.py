"""Where the time of the W4 and speculative sampling paths goes, for the
PyTorch port on one GPU.

Not a pytest file:

    python tests/bench_torch_sample.py [out.json]

GPT-L 384, random seeded weights with a random head, batch 8 + CFG:

- the W4 path: grouped W4 layer weights (`quantize_gpt_params_w4k`
  defaults) + bf16 KV, the decode loop of `ops/generate.py` (decode_step,
  cfg_mix 2.0, sample) at positions 289..320;
- the speculative path: the bf16 model as target, a W4 copy of it as draft,
  k 4, CFG 4.0, sampled, `generate_speculative` over 64 tokens.

Each is timed on the host clock (ending in a device sync), then traced with
`torch.profiler`; reported per decode step or per verify round: wall ms,
device busy ms (the union of kernel intervals, so overlapping kernels
count once), the idle share, kernels launched, and device ms by group (K1
decode attention, K3 W4 matmul, K5 chunk attention, the separate insert and
split-K launches, cuBLAS, the rest). Then the host cost of one wrapper
call (`w4_matmul` at wqkv B 16, `chunk_decode_attention` at C 5, pos
288): host µs per call over 2000 calls enqueued back to back.
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
    for keys, group in ((("decode_attn",), "K1 decode attention"),
                        (("w4_mma", "w4_matmul"), "K3 W4 matmul"),
                        (("chunk_mma", "chunk_attn"), "K5 chunk attention")):
        if any(k in low for k in keys):
            return group
    if "insert_kernel" in low or "insert_flush" in low \
            or "finish_kernel" in low:
        return "K1/K2/K5 insert and split-K launches"
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


def _wrapper_host_us(w4_model, cache, dev, calls=2000):
    """Host µs per wrapper call, enqueued back to back (the device work of
    a call is shorter than its host cost, so the queue never fills)."""
    from llamagen_tpu_torch.ops.chunk_attention import chunk_decode_attention
    from llamagen_tpu_torch.ops.w4_matmul import w4_matmul
    lin = w4_model.layers[0].attention.wqkv
    x = torch.randn(16, lin.weight_w4b.shape[1] * 2, device=dev,
                    dtype=torch.bfloat16)
    q = torch.randn(16, 5, 1024, device=dev, dtype=torch.bfloat16)
    kv_new = torch.randn(16, 5, 2048, device=dev, dtype=torch.bfloat16)
    kv = cache.kv[0]
    out = {}
    for name, fn in (("w4_matmul", lambda: w4_matmul(x, lin.weight_w4b,
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


def main(argv):
    out_path = argv[0] if argv else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from llamagen_tpu_torch.config import find_multiple, gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops import sampling
    from llamagen_tpu_torch.ops.speculative import generate_speculative
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = gpt_config("GPT-L", block_size=576, cls_token_num=1)
    model = gpt.init_weights(gpt.Transformer(cfg, device=dev,
                                             dtype=torch.bfloat16), seed=0)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=torch.Generator(
            device=dev).manual_seed(1))
    model.eval()
    w4 = quantize_gpt_params_w4k(copy.deepcopy(model))
    labels = torch.arange(8, device=dev) * 100 % 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"card": smi}

    # the W4 decode loop at positions 289..320 (the cache holds zeros
    # below: the work per step depends on the position only)
    cache = gpt.init_cache(cfg, 16, find_multiple(577, 128), torch.bfloat16,
                           dev)
    tok = torch.zeros(8, dtype=torch.long, device=dev)

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

    w4_steps(8)  # warm-up: kernel build, allocator, cuBLAS plans
    res["w4_step"] = _profile(w4_steps)
    spec()
    res["spec_round"] = _profile(spec)
    res["host_us_per_call"] = _wrapper_host_us(w4, cache, dev)
    for path in ("w4_step", "spec_round"):
        r = res[path]
        print(f"{path} (x{r['units']}): wall {r['wall_ms']:.2f} ms, device "
              f"busy {r['device_busy_ms']:.2f} ms (idle "
              f"{100 * r['idle_share']:.1f} %), {r['kernels']:.0f} kernels")
        for g, ms in sorted(r["device_ms_by_group"].items(),
                            key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {g}")
    print(f"host us per wrapper call: {res['host_us_per_call']}")
    line = json.dumps(res)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
