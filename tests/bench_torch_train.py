"""Where the time of a training step goes, for the PyTorch port on one GPU.

Not a pytest file:

    python tests/bench_torch_train.py [GPT-L] [384] [32] [out.json]
    python tests/bench_torch_train.py --t2i [GPT-XL] [256] [32] [out.json]
    python tests/bench_torch_train.py --vq [--knockouts] [out.json]

Builds the trainer of `llamagen_tpu_torch.train.c2i` (seeded weights,
bf16 compute, f32 master weights, AdamW + EMA, full remat, the CLI's
default dropouts) on synthetic codes; with `--t2i` the trainer of
`train/t2i.py` (120 caption rows x 2048 left-padded by 0-119, one sample
with valid 0, a frozen bf16 VQ-16 tokenizing random images inside the
step). Times steps on the host clock (each ends in a device sync), then
traces three steps with `torch.profiler` and reports:

- the device busy time per step (the union of the traced kernel
  intervals, so overlapping kernels count once) and the idle share;
- device time by kernel group: the training-attention kernels (K4), the
  convolutions (cuDNN: the VQ encode of t2i), the other matrix products
  (cuBLAS), the optimizer and EMA (`foreach` / AdamW kernels), and the
  rest (elementwise, reductions, copies, GroupNorm, the cross-entropy over
  the [B, S, V] f32 logits);
- the 20 kernels with the most device time (all of them in the JSON).

With `--vq`, the VQ-GAN tokenizer trainer of `train/vq.py` (VQ-16 at
256 px, bf16 compute over f32 weights, per-block remat, PatchGAN, hinge,
l2, disc_start 0 so every term and both updates run, a full-width random
LPIPS, EMA) at batches 16, 32 and 64: s per step, img/s and peak memory
each; at batch 32 the profile, with the device time by group
(convolutions; GroupNorm, BatchNorm and elementwise; the optimizers and
EMA; the attention blocks' matmuls), the idle share, and the VGG's own
device time (LPIPS forward + backward of a batch of reconstructions,
traced alone). `--knockouts` adds the step at batch 32 without LPIPS,
without the discriminator, and with neither (reconstruction only).

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
VQ_MODEL, VQ_SIZE, VQ_BATCHES = "VQ-16", 256, (16, 32, 64)


def _group(name: str) -> str:
    low = name.lower()
    if "train_attention" in low:  # csrc/train_attention.cu's namespace
        return "K4 training attention"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv",
                              "nchwtonhwc", "nhwctonchw")):
        return "convolutions (cuDNN)"
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


def t2i_setup(model, image, batch, dev):
    """(state, step_fn, batch_at, positions per sample, extra results) of
    the t2i trainer; also the VQ encode's own time per batch."""
    from llamagen_tpu_torch.config import gpt_config, vq_config
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.train import t2i

    latent = image // 16
    cfg = gpt_config(model, block_size=latent * latent, cls_token_num=120,
                     model_type="t2i", caption_dim=2048)
    vq_model = vq.init_weights(vq.VQModel(
        vq_config("VQ-16"), device=dev, dtype=torch.bfloat16, encoder=True),
        seed=7).eval()
    state, step_fn = t2i.build_trainer(cfg, vq_model, dev)
    rng = np.random.RandomState(0)

    def batch_at(i):
        imgs = rng.uniform(-1, 1, (batch, image, image, 3)).astype(np.float32)
        feats = rng.randn(batch, 120, 2048).astype(np.float32)
        pads = (np.arange(batch) * 119 // max(batch - 1, 1) + 7 * i) % 120
        masks = (np.arange(120)[None, :] >= pads[:, None]).astype(np.int32)
        feats[masks == 0] = 0
        valid = np.ones(batch, np.float32)
        valid[1 % batch] = 0
        return t2i.T2IBatch(*(torch.from_numpy(a).to(dev)
                              for a in (imgs, feats, masks, valid)))

    x = batch_at(0).images.to(torch.bfloat16)
    with torch.no_grad():
        vq_model.encode(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            vq_model.encode(x)
        end.record()
        torch.cuda.synchronize()
    extra = {"vq_encode_ms_per_batch": start.elapsed_time(end) / 5}
    return state, step_fn, batch_at, 120 + latent * latent - 1, extra


def _device_profile(fn, n):
    """Run fn() n times under torch.profiler: (busy ms per run, kernels per
    run, ms per run by kernel name)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / 1e3 / n
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3 / n
    return busy, len(kernels) / n, by_name


def vq_trainer(batch, dev, lpips=True, use_disc=True):
    """The VQ-GAN trainer at the JAX CLI's settings (disc_start 0) and a
    step closure on fixed random images."""
    from llamagen_tpu_torch.config import vq_config
    from llamagen_tpu_torch.models import lpips as lpips_lib
    from llamagen_tpu_torch.train import vq as vq_train

    lp = lpips_lib.init_weights(lpips_lib.LPIPS(device=dev), seed=9) \
        if lpips else None
    state, step_fn = vq_train.build_trainer(
        vq_config(VQ_MODEL), vq_train.VQLossConfig(disc_start=0), dev,
        use_ema=True, lpips=lp, use_disc=use_disc,
        compute_dtype=torch.bfloat16, remat=True)
    g = torch.Generator(device=dev).manual_seed(0)
    imgs = torch.rand(batch, VQ_SIZE, VQ_SIZE, 3, generator=g,
                      device=dev) * 2 - 1

    def step():
        _, m = step_fn(state, imgs)
        return m

    return state, step, lp, imgs


def vq_time(batch, dev, n=6, **kw):
    """(s per step median, peak GiB, the step closure and its parts)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    parts = vq_trainer(batch, dev, **kw)
    step = parts[1]
    for _ in range(2):  # warm-up: allocator, cuDNN plans
        float(step()["gen_loss"])
    times = []
    for _ in range(n):
        t0 = time.time()
        float(step()["gen_loss"])  # waits for the step
        times.append(time.time() - t0)
    return statistics.median(times), times, \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30, parts


def vq_main(argv, smi, dev):
    knockouts = "--knockouts" in argv
    argv = [a for a in argv if not a.startswith("--")]
    out_path = argv[0] if argv else None
    res = {"card": smi, "model": VQ_MODEL, "image_size": VQ_SIZE,
           "compute": "bf16 over f32 weights, per-block remat",
           "disc": "patchgan", "batches": {}}
    for batch in VQ_BATCHES:
        step_s, times, peak, parts = vq_time(batch, dev)
        res["batches"][batch] = {"step_s_median": step_s,
                                 "step_s_all": times,
                                 "img_per_s": batch / step_s,
                                 "peak_memory_gib": peak}
        print(f"batch {batch}: {step_s:.4f} s/step, {batch / step_s:.2f} "
              f"img/s, peak {peak:.2f} GiB")
        if batch != VQ_BATCHES[1]:
            del parts
            continue
        busy, n_k, by_name = _device_profile(parts[1], 3)
        groups = {}
        for name, ms in by_name.items():
            g = _group(name)
            if g.startswith("other"):
                g = "GroupNorm, BatchNorm, elementwise, reductions, copies"
            groups[g] = groups.get(g, 0.0) + ms
        _, _, lp, imgs = parts
        recons = imgs.to(torch.bfloat16).requires_grad_(True)

        def vgg():
            lp.mean(imgs.to(torch.bfloat16), recons, remat=True).backward()

        vgg()
        vgg_busy, vgg_k, _ = _device_profile(vgg, 3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
        res["profile_batch_32"] = {
            "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / (step_s * 1e3),
            "kernels_per_step": n_k,
            "device_ms_per_step_by_group": groups,
            "vgg_alone_device_ms": vgg_busy, "vgg_alone_kernels": vgg_k,
            "top_kernels_ms_per_step": top}
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"{g}: {ms:.2f} ms/step")
        print(f"device busy {busy:.1f} ms/step, idle "
              f"{100 * (1 - busy / (step_s * 1e3)):.2f} %, {n_k:.0f} "
              f"kernels; the VGG alone (LPIPS fwd + bwd): {vgg_busy:.1f} ms")
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:110]}")
        del parts, recons
    if knockouts:
        res["knockouts_batch_32"] = {}
        for label, kw in (("no LPIPS", dict(lpips=False)),
                          ("no discriminator", dict(use_disc=False)),
                          ("reconstruction only",
                           dict(lpips=False, use_disc=False))):
            step_s, times, peak, parts = vq_time(VQ_BATCHES[1], dev, **kw)
            del parts
            res["knockouts_batch_32"][label] = {
                "step_s_median": step_s, "step_s_all": times,
                "peak_memory_gib": peak}
            print(f"knockout {label}: {step_s:.4f} s/step, peak "
                  f"{peak:.2f} GiB")
    line = json.dumps(res)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
    print(line)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if "--vq" in argv:
        return vq_main([a for a in argv if a != "--vq"], smi,
                       torch.device("cuda"))
    t2i_mode = "--t2i" in argv
    argv = [a for a in argv if a != "--t2i"]
    model = argv[0] if argv else ("GPT-XL" if t2i_mode else "GPT-L")
    image = int(argv[1]) if len(argv) > 1 else (256 if t2i_mode else 384)
    batch = int(argv[2]) if len(argv) > 2 else 32
    out_path = argv[3] if len(argv) > 3 else None
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.train import c2i

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    latent = image // 16
    tokens = latent * latent
    extra = {}
    if t2i_mode:
        state, step_fn, batch_at, tokens, extra = t2i_setup(model, image,
                                                            batch, dev)
    else:
        cfg = gpt_config(model, block_size=tokens, cls_token_num=1)
        state, step_fn = c2i.build_trainer(cfg, dev)
        rng = np.random.RandomState(0)

        def batch_at(i):
            return c2i.Batch(
                labels=torch.from_numpy(rng.randint(0, 1000, (batch,)))
                .to(dev),
                tokens=torch.from_numpy(rng.randint(0, 16384,
                                                    (batch, tokens)))
                .to(dev))
    n_params = sum(p.numel() for p in state.model.parameters())

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
        "card": smi, "model": model, "t2i": t2i_mode, "image_size": image,
        "batch": batch, "positions_per_sample": tokens, "params": n_params,
        "step_s_median": step_s,
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
        **extra,
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
