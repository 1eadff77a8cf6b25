"""VQ-GAN tokenizer training CLI (PyTorch port of
`llamagen_tpu/cli/train_vq.py`, one device).

Alternating generator / discriminator updates (`train/vq.py`) with LPIPS
and adversarial losses, an optional EMA and checkpoints. Data: an
ImageFolder directory (short-side resize to 1.25x, random crop, hflip) or
synthetic uniform images (`--synthetic-steps`). The same flags and
defaults as JAX's, plus `--device` (default cuda; no CPU fallback). LPIPS
is on only with `--vgg-weights` (a torchvision vgg16 state dict), and then
`--lpips-lins` (the reference's `vgg.pth` heads) is required. One device:
`--dp` above 1 raises `NotImplementedError`. Writes the log,
`metrics.jsonl` every `--log-every` steps and `checkpoints/step_*.pt`
(`utils/checkpoint.py::save_vq_step`; its "model" entry loads as a
tokenizer).

  python -m llamagen_tpu_torch.cli.train_vq --data-path /data/imagenet/train \\
      --image-size 256 --vq-model VQ-16
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device
from llamagen_tpu_torch.config import vq_config
from llamagen_tpu_torch.models import lpips as lpips_lib
from llamagen_tpu_torch.train import vq as vq_train
from llamagen_tpu_torch.utils import checkpoint
from llamagen_tpu_torch.utils.logger import create_logger
from llamagen_tpu_torch.utils.metrics import MetricsLogger


def image_batches(root, image_size, batch_size, seed=0):
    """Random-crop (after a short-side resize to 1.25x, aspect kept) +
    hflip ImageFolder stream of f32 NHWC batches in [-1, 1]."""
    from PIL import Image

    paths = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                paths.append(os.path.join(dirpath, f))
    rng = np.random.RandomState(seed)
    while True:
        sel = rng.choice(len(paths), size=batch_size)
        imgs = []
        for i in sel:
            try:
                img = Image.open(paths[i]).convert("RGB")
            except OSError:
                continue
            r = int(image_size * 1.25)
            w0, h0 = img.size
            if w0 <= h0:
                w1, h1 = r, max(r, round(r * h0 / w0))
            else:
                w1, h1 = max(r, round(r * w0 / h0)), r
            img = img.resize((w1, h1), Image.BICUBIC)
            y = rng.randint(0, h1 - image_size + 1)
            x = rng.randint(0, w1 - image_size + 1)
            arr = np.array(img)[y:y + image_size, x:x + image_size]
            if rng.rand() < 0.5:
                arr = arr[:, ::-1]
            imgs.append(arr)
        if len(imgs) == batch_size:
            yield np.stack(imgs).astype(np.float32) / 127.5 - 1.0


def synthetic_batches(image_size, batch_size, seed=0):
    rng = np.random.RandomState(seed)
    while True:
        yield rng.uniform(-1, 1, (batch_size, image_size, image_size, 3)
                          ).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", default=None)
    p.add_argument("--synthetic-steps", type=int, default=0)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--global-batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=-1)
    p.add_argument("--disc-start", type=int, default=20000)
    p.add_argument("--disc-weight", type=float, default=0.5)
    p.add_argument("--disc-adaptive-weight", action="store_true",
                   help="grad-norm-ratio adaptive GAN weight")
    p.add_argument("--disc-type", default="patchgan",
                   choices=["patchgan", "stylegan"])
    p.add_argument("--disc-loss", default="hinge",
                   choices=["hinge", "vanilla", "non-saturating"])
    p.add_argument("--gen-loss", default="hinge",
                   choices=["hinge", "non-saturating"])
    p.add_argument("--rec-loss", default="l2", choices=["l1", "l2"])
    p.add_argument("--dropout-p", type=float, default=0.0,
                   help="residual-block dropout")
    p.add_argument("--perceptual-weight", type=float, default=1.0)
    p.add_argument("--vgg-weights", default=None,
                   help="torchvision vgg16 state dict (.pt) for LPIPS; "
                        "without it LPIPS is off")
    p.add_argument("--lpips-lins", default=None,
                   help="the LPIPS heads (the reference's vgg.pth); "
                        "required with --vgg-weights")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--mixed-precision", default="bf16",
                   choices=["none", "bf16"],
                   help="compute dtype; weights and optimizers stay f32")
    p.add_argument("--no-remat", action="store_true",
                   help="disable per-block activation checkpointing")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel size: one device (-1 or 1) only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--results-dir", default="results_vq")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.dp > 1:
        raise NotImplementedError(
            "multi-GPU VQ-GAN training (DDP) is not ported yet "
            "(ROADMAP.md, Queue 1 item 5)")
    if args.vgg_weights and not args.lpips_lins:
        p.error("--vgg-weights needs --lpips-lins (the LPIPS heads)")
    device = get_device(args.device)
    cfg = vq_config(args.vq_model, codebook_size=args.codebook_size,
                    codebook_embed_dim=args.codebook_embed_dim,
                    dropout_p=args.dropout_p)
    loss_cfg = vq_train.VQLossConfig(
        disc_start=args.disc_start, disc_weight=args.disc_weight,
        disc_type=args.disc_type, disc_loss=args.disc_loss,
        gen_adv_loss=args.gen_loss, reconstruction_loss=args.rec_loss,
        perceptual_weight=args.perceptual_weight if args.vgg_weights else 0.0,
        disc_adaptive_weight=args.disc_adaptive_weight,
        image_size=args.image_size)

    lpips = None
    if args.vgg_weights:
        def load(path):
            return torch.load(path, map_location="cpu", weights_only=True)
        lpips = lpips_lib.load_lpips(load(args.vgg_weights),
                                     load(args.lpips_lins), device=device)

    os.makedirs(args.results_dir, exist_ok=True)
    logger = create_logger(args.results_dir)
    logger.info(f"device {device}; {args.vq_model} at {args.image_size} px, "
                f"batch {args.global_batch_size}, LPIPS "
                f"{'on' if lpips is not None else 'off'}")
    mlog = MetricsLogger(args.results_dir, config=vars(args))
    state, step_fn = vq_train.build_trainer(
        cfg, loss_cfg, device, lr=args.lr, use_ema=args.ema,
        ema_decay=0.999, seed=args.seed, lpips=lpips,
        compute_dtype=(torch.bfloat16 if args.mixed_precision == "bf16"
                       else torch.float32),
        remat=not args.no_remat)

    if args.synthetic_steps > 0:
        batches = synthetic_batches(args.image_size, args.global_batch_size,
                                    args.seed)
        max_steps = args.synthetic_steps
    elif args.data_path:
        batches = image_batches(args.data_path, args.image_size,
                                args.global_batch_size, args.seed)
        max_steps = args.max_steps
    else:
        raise SystemExit("need --data-path or --synthetic-steps")

    ckpt_dir = os.path.join(args.results_dir, "checkpoints")
    t0, last = time.time(), 0
    for imgs in batches:
        if 0 < max_steps <= state.step:
            break
        state, metrics = step_fn(state, torch.from_numpy(imgs).to(device))
        step = state.step
        if step % args.log_every == 0:
            values = {k: float(v) for k, v in metrics.items()}  # waits
            sps = (step - last) / (time.time() - t0)
            logger.info(
                f"step {step}: rec {values['rec_loss']:.4f} "
                f"perc {values['perceptual_loss']:.4f} "
                f"vq {values['vq_loss']:.4f} "
                f"commit {values['commit_loss']:.4f} "
                f"usage {values['codebook_usage']:.3f} "
                f"d {values['disc_loss']:.4f} ({sps:.2f} steps/s, "
                f"{sps * args.global_batch_size:.1f} img/s)")
            mlog.log(step, {**values, "steps_per_sec": sps,
                            "samples_per_sec": sps * args.global_batch_size})
            t0, last = time.time(), step
        if step % args.ckpt_every == 0:
            path = checkpoint.save_vq_step(ckpt_dir, step, state)
            logger.info(f"saved {path}")

    path = checkpoint.save_vq_step(ckpt_dir, state.step, state)
    if device.type == "cuda":
        logger.info(f"peak device memory "
                    f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                    f"GiB")
    logger.info(f"done at step {state.step}; final checkpoint {path}")
    mlog.close()
    return state


if __name__ == "__main__":
    main()
