"""Text-conditional GPT training CLI (PyTorch port of
`llamagen_tpu/cli/train_t2i.py`).

Trains on images + precomputed T5 caption features (a jsonl dataset,
`data/t2i.py`), tokenizing the images with a frozen VQ model inside the
step (`train/t2i.py`), with per-sample caption masks and the `valid`
bad-sample loss mask. Same flags and defaults as the JAX CLI, plus
`--device`; `metrics.jsonl`, periodic and final
checkpoints, resume (from any layout, `cli/train_c2i.py`). Across GPUs
under torchrun, `--dp` / `--fsdp` / `--tp` as in `cli/train_c2i.py` (DDP,
FSDP2, HSDP, tensor parallelism; sharded DCP checkpoints and a whole-model
export); the frozen VQ and the
caption embedder are whole on every rank, and the VQ encodes that rank's
images (the ranks of a TP group encode the same rows).

  python -m llamagen_tpu_torch.cli.train_t2i --jsonl data/items.jsonl \\
      --t5-feature-dir data/t5 --vq-ckpt vq_ds16_t2i.pt \\
      --gpt-model GPT-XL --image-size 256
  torchrun --nproc_per_node 8 -m llamagen_tpu_torch.cli.train_t2i ...

Smoke mode (no data needed): --synthetic-steps N (the caption window
shrinks to 8 tokens of 64 features).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import (add_parallel_args, get_device,
                                           load_vq, process_group)
from llamagen_tpu_torch.config import gpt_config
from llamagen_tpu_torch.data.t2i import T2IDataset
from llamagen_tpu_torch.parallel import distributed
from llamagen_tpu_torch.parallel.mesh import (data_rank_world,
                                              local_batch_size, rank_rows)
from llamagen_tpu_torch.train import t2i
from llamagen_tpu_torch.utils import checkpoint
from llamagen_tpu_torch.utils.logger import (create_experiment_dir,
                                             create_logger)
from llamagen_tpu_torch.utils.metrics import MetricsLogger


def synthetic_batches(batch: int, image_size: int, t5_len: int,
                      caption_dim: int, seed: int = 0):
    """Endless random (images, features, masks, valid): each batch's
    captions left-padded by one random amount in [0, t5_len / 2)."""
    rng = np.random.RandomState(seed)
    while True:
        imgs = rng.uniform(-1, 1, (batch, image_size, image_size, 3)
                           ).astype(np.float32)
        feats = rng.randn(batch, t5_len, caption_dim).astype(np.float32)
        masks = np.ones((batch, t5_len), np.int32)
        masks[:, :rng.randint(0, t5_len // 2)] = 0
        feats[masks == 0] = 0
        valid = np.ones((batch,), np.float32)
        yield imgs, feats, masks, valid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--jsonl", default=None,
                   help="jsonl of {image_path, caption_idx} rows")
    p.add_argument("--t5-feature-dir", default=None,
                   help="dir of {idx}.npz T5 features "
                        "(cli.extract_t5_features)")
    p.add_argument("--synthetic-steps", type=int, default=0,
                   help="train on synthetic data for N steps (smoke mode)")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--gpt-model", default="GPT-XL")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--cls-token-num", type=int, default=120)
    p.add_argument("--caption-dim", type=int, default=2048)
    p.add_argument("--class-dropout-prob", type=float, default=0.1)
    p.add_argument("--dropout-p", type=float, default=0.1,
                   help="resid/ffn dropout")
    p.add_argument("--token-dropout-p", type=float, default=0.1)
    p.add_argument("--drop-path", type=float, default=0.0,
                   help="stochastic depth; >0 zeroes dropout-p")
    p.add_argument("--global-batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=5e-2)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--max-steps", type=int, default=-1)
    p.add_argument("--no-ema", action="store_true")
    add_parallel_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--results-dir", default="results_t2i")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from (its newest step, "
                        "saved at any layout or in one process)")
    p.add_argument("--exp-auto", action="store_true",
                   help="create an auto-numbered {index:03d}-{model} "
                        "experiment subdir")
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics.jsonl to wandb when importable")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with process_group(args, get_device(args.device)) as (device, mesh):
        return train(args, device, mesh)


def train(args, device, mesh):
    # the data-parallel rank and world: the ranks of a TP group share rows
    rank, world = data_rank_world(mesh)
    latent = args.image_size // args.downsample_size
    if args.synthetic_steps > 0:
        # shrink the caption window so that the smoke run stays fast
        args.cls_token_num = min(args.cls_token_num, 8)
        args.caption_dim = min(args.caption_dim, 64)
    dropout_p = 0.0 if args.drop_path > 0.0 else args.dropout_p
    cfg = gpt_config(args.gpt_model, block_size=latent * latent,
                     cls_token_num=args.cls_token_num, model_type="t2i",
                     caption_dim=args.caption_dim,
                     class_dropout_prob=args.class_dropout_prob,
                     resid_dropout_p=dropout_p, ffn_dropout_p=dropout_p,
                     token_dropout_p=args.token_dropout_p,
                     drop_path_rate=args.drop_path)
    compute_dtype = torch.bfloat16
    vq_model = load_vq(args.vq_ckpt, args.vq_model, 16384, 8, compute_dtype,
                       device, encoder=True)

    if args.exp_auto:
        args.results_dir = create_experiment_dir(args.results_dir,
                                                 args.gpt_model)
    os.makedirs(args.results_dir, exist_ok=True)
    logger = create_logger(args.results_dir)
    logger.info(f"device {device}; mesh {mesh}; model {args.gpt_model} "
                f"t2i ({latent}x{latent} tokens, T={cfg.cls_token_num})")
    mlog = MetricsLogger(args.results_dir, use_wandb=args.wandb,
                         config=vars(args),
                         is_main=distributed.is_main_process())

    state, step_fn = t2i.build_trainer(
        cfg, vq_model, device, lr=args.lr, weight_decay=args.weight_decay,
        beta1=args.beta1, beta2=args.beta2,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.warmup_steps,
        use_ema=not args.no_ema, seed=args.seed,
        compute_dtype=compute_dtype, mesh=mesh)

    start_step = 0
    if args.resume:
        # any layout the directory holds, onto the one the flags ask for
        step, restored = checkpoint.restore_latest(args.resume, state,
                                                   log=logger.info)
        if restored is not None:
            start_step = step

    host_batch = local_batch_size(args.global_batch_size, world)
    if args.synthetic_steps > 0:
        # every rank draws the global batch and keeps its rows
        it = (tuple(rank_rows(x, rank, world) for x in b)
              for b in synthetic_batches(args.global_batch_size,
                                         args.image_size, cfg.cls_token_num,
                                         cfg.caption_dim, seed=args.seed))
        max_steps = args.synthetic_steps
    elif args.jsonl and args.t5_feature_dir:
        ds = T2IDataset(args.jsonl, args.t5_feature_dir, args.image_size,
                        caption_dim=cfg.caption_dim,
                        t5_len=cfg.cls_token_num)
        it = ds.batches(host_batch, seed=args.seed, epochs=args.epochs,
                        num_hosts=world, host_id=rank)
        max_steps = args.max_steps
    else:
        raise SystemExit("need --jsonl + --t5-feature-dir, or "
                         "--synthetic-steps")

    t0, last_log = time.time(), start_step
    running_loss = 0.0
    step = start_step
    ckpt_dir = os.path.join(args.results_dir, "checkpoints")
    for imgs, feats, masks, valid in it:
        if max_steps > 0 and step >= max_steps:
            break
        batch = t2i.T2IBatch(
            images=torch.from_numpy(imgs).to(device),
            captions=torch.from_numpy(feats).to(device),
            emb_masks=torch.from_numpy(masks).to(device),
            valid=torch.from_numpy(valid).to(device))
        state, metrics = step_fn(state, batch, args.seed)
        step += 1
        running_loss += float(metrics["loss"])  # waits for the step
        if step % args.log_every == 0:
            dt = time.time() - t0
            sps = (step - last_log) / dt
            avg_loss = running_loss / (step - last_log)
            logger.info(f"step {step}: loss {avg_loss:.4f} "
                        f"({sps:.2f} steps/s, "
                        f"{sps * args.global_batch_size:.0f} samples/s)")
            mlog.log(step, {"loss": avg_loss, "steps_per_sec": sps,
                            "samples_per_sec": sps * args.global_batch_size,
                            "grad_norm": float(metrics["grad_norm"])})
            running_loss, t0, last_log = 0.0, time.time(), step
        if step % args.ckpt_every == 0:
            path = checkpoint.save_step(ckpt_dir, step, state)
            logger.info(f"saved checkpoint {path}")

    path = checkpoint.save_step(ckpt_dir, step, state)
    if mesh is not None:
        checkpoint.save_full_model(
            os.path.join(ckpt_dir, f"step_{step:08d}_model.pt"), state)
    logger.info(f"done at step {step}; final checkpoint {path}")
    mlog.close()
    return state


if __name__ == "__main__":
    main()
