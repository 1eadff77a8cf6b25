"""Where the time of a training step goes, for the PyTorch port on one GPU.

Not a pytest file:

    python tests/bench_torch_train.py [GPT-L] [384] [32] [out.json]

Builds the trainer of `llamagen_tpu_torch.train.c2i` (seeded weights,
bf16 compute, f32 master weights, AdamW + EMA, full remat, the CLI's
default dropouts) on synthetic codes. Times steps on the host clock (each
ends in a device sync), then traces three steps with `torch.profiler` and
reports:

- the device busy time per step (the union of the traced kernel
  intervals, so overlapping kernels count once) and the idle share;
- device time by kernel group: the training-attention kernels (K4), the
  other matrix products (cuBLAS), the optimizer and EMA (`foreach` /
  AdamW kernels), and the rest (elementwise, reductions, copies, the
  cross-entropy over the [B, S, V] f32 logits);
- the 20 kernels with the most device time (all of them in the JSON).

Prints a JSON object as its last line (and writes it to `out.json` when
given). Needs a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

H100_BF16_FLOPS = 989e12  # dense, NVIDIA's data sheet (SXM, 700 W)


def _group(name: str) -> str:
    low = name.lower()
    if "train_attention" in low:  # csrc/train_attention.cu's namespace
        return "K4 training attention"
    if "gemm" in low or "cutlass" in low or "xmma" in low \
            or low.startswith("nvjet"):
        return "matmul (cuBLAS)"
    if "foreach" in low or "adam" in low or "multi_tensor" in low:
        return "optimizer + EMA"
    return "other (elementwise, reductions, copies, loss)"


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv):
    model = argv[0] if argv else "GPT-L"
    image = int(argv[1]) if len(argv) > 1 else 384
    batch = int(argv[2]) if len(argv) > 2 else 32
    out_path = argv[3] if len(argv) > 3 else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.train import c2i

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    latent = image // 16
    tokens = latent * latent
    cfg = gpt_config(model, block_size=tokens, cls_token_num=1)
    state, step_fn = c2i.build_trainer(cfg, dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    rng = np.random.RandomState(0)

    def batch_at(i):
        return c2i.Batch(
            labels=torch.from_numpy(rng.randint(0, 1000, (batch,))).to(dev),
            tokens=torch.from_numpy(rng.randint(0, 16384, (batch, tokens)))
            .to(dev))

    for i in range(3):  # warm-up: kernel build, allocator, cuBLAS plans
        step_fn(state, batch_at(i), 0)
    torch.cuda.synchronize()
    times = []
    for i in range(8):
        b = batch_at(i)
        t0 = time.time()
        _, m = step_fn(state, b, 0)
        float(m["loss"])
        times.append(time.time() - t0)
    step_s = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_prof = 3
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_prof):
            _, m = step_fn(state, batch_at(i), 0)
            float(m["loss"])
    # device intervals, without the profiler's annotations of host ranges
    # mirrored on the device ("Optimizer.step#AdamW.step", ...)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3 / n_prof
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3 / n_prof
    groups = {}
    for name, ms in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    res = {
        "card": smi, "model": model, "image_size": image, "batch": batch,
        "params": n_params, "step_s_median": step_s,
        "step_s_all": times, "samples_per_s": batch / step_s,
        "tokens_per_s": batch * tokens / step_s,
        "mfu": 6 * n_params * batch * tokens / step_s / H100_BF16_FLOPS,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1 - busy_ms / (step_s * 1e3),
        "kernels_per_step": len(kernels) / n_prof,
        "device_ms_per_step_by_group": groups,
        "top_kernels_ms_per_step": top,
        "all_kernels_ms_per_step": by_name,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
    }
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{g}: {ms:.2f} ms/step")
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:110]}")
    line = json.dumps(res)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
