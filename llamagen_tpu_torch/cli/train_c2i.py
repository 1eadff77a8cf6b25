"""Class-conditional GPT training CLI (PyTorch port).

Same flags and flow as `llamagen_tpu/cli/train_c2i.py`, plus `--device`:
synthetic, packed-shard, reference-npy (repacked once) or raw-shard (the
threaded native loader) inputs; `metrics.jsonl`; periodic and final
checkpoints; resume.

Across GPUs, under torchrun: `--fsdp` ranks shard the model (FSDP2; the
default `--fsdp -1` takes every rank), `--dp` ranks replicate it (DDP),
both at once give HSDP, and `--tp` ranks split its heads, FFN hidden dim
and vocabulary (Megatron's tensor parallelism, adjacent ranks; composes
with the other two) (`parallel/`). Each data-parallel rank takes its
stride of the global batch (the ranks of a TP group the same rows), logs
and metrics come from rank 0, and checkpoints are sharded DCP
directories, the final one beside a whole-model `step_XXXXXXXX_model.pt`
(upstream's layout, TP shards gathered) that the sampling CLIs load.
`--resume` reads a checkpoint saved at any (dp, fsdp, tp) or by one
process and logs both layouts (`utils/checkpoint.py`). `--backend gloo`
lets ranks share one card.

  python -m llamagen_tpu_torch.cli.train_c2i --code-path /data/codes \
      --gpt-model GPT-L --image-size 384 --global-batch-size 32
  torchrun --nproc_per_node 8 -m llamagen_tpu_torch.cli.train_c2i \
      --code-path /data/codes --gpt-model GPT-XL --global-batch-size 256
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import (add_parallel_args, get_device,
                                           min_over_ranks,
                                           process_group)
from llamagen_tpu_torch.config import gpt_config
from llamagen_tpu_torch.data.codes import (NpyCodeDataset, PackedCodeDataset,
                                           SyntheticCodeDataset, pack_shards)
from llamagen_tpu_torch.parallel import distributed
from llamagen_tpu_torch.parallel.mesh import (data_rank_world,
                                              local_batch_size, rank_rows)
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.utils import checkpoint, profiling
from llamagen_tpu_torch.utils.logger import (create_experiment_dir,
                                             create_logger)
from llamagen_tpu_torch.utils.metrics import MetricsLogger


def _has(path, suffixes) -> bool:
    return bool(path) and os.path.isdir(path) and any(
        f.endswith(suffixes) for f in os.listdir(path))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--code-path", default=None,
                   help="packed shard dir, or reference-layout code dir")
    p.add_argument("--label-path", default=None,
                   help="labels dir for reference npy layout")
    p.add_argument("--synthetic-steps", type=int, default=0,
                   help="train on synthetic data for N steps (smoke mode)")
    p.add_argument("--gpt-model", default="GPT-B")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--class-dropout-prob", type=float, default=0.1)
    p.add_argument("--dropout-p", type=float, default=0.1,
                   help="resid/ffn dropout")
    p.add_argument("--token-dropout-p", type=float, default=0.1)
    p.add_argument("--drop-path-rate", type=float, default=0.0,
                   help="stochastic depth; >0 zeroes dropout-p")
    p.add_argument("--global-batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=5e-2)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--max-steps", type=int, default=-1)
    p.add_argument("--no-ema", action="store_true")
    add_parallel_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--results-dir", default="results")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from (its newest step, "
                        "saved at any layout or in one process)")
    p.add_argument("--exp-auto", action="store_true",
                   help="create an auto-numbered {index:03d}-{model} "
                        "experiment subdir")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 2..4 here")
    p.add_argument("--memory-analysis", action="store_true",
                   help="log the device's peak memory after the first step")
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics.jsonl to wandb when importable")
    p.add_argument("--remat", default="full",
                   choices=["full", "save_attn", "none"],
                   help="rematerialization policy: full layer remat "
                        "(default), save_attn (selective: save each layer's "
                        "attention output, recompute the rest), or none")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with process_group(args, get_device(args.device)) as (device, mesh):
        return train(args, device, mesh)


def train(args, device, mesh):
    # the data-parallel rank and world: the ranks of a TP group share rows
    rank, world = data_rank_world(mesh)
    is_main = distributed.is_main_process()
    latent = args.image_size // args.downsample_size
    # drop-path replaces resid/ffn dropout (ref train_c2i.py:97-100)
    dropout_p = 0.0 if args.drop_path_rate > 0.0 else args.dropout_p
    cfg = gpt_config(args.gpt_model, block_size=latent * latent,
                     cls_token_num=1,
                     class_dropout_prob=args.class_dropout_prob,
                     resid_dropout_p=dropout_p, ffn_dropout_p=dropout_p,
                     token_dropout_p=args.token_dropout_p,
                     drop_path_rate=args.drop_path_rate)

    if args.exp_auto:
        args.results_dir = create_experiment_dir(args.results_dir,
                                                 args.gpt_model)
    os.makedirs(args.results_dir, exist_ok=True)
    logger = create_logger(args.results_dir)
    logger.info(f"device {device}; mesh {mesh}; model {args.gpt_model} "
                f"({latent}x{latent} tokens)")
    mlog = MetricsLogger(args.results_dir, use_wandb=args.wandb,
                         config=vars(args), is_main=is_main)

    state, step_fn = c2i.build_trainer(
        cfg, device, lr=args.lr, weight_decay=args.weight_decay,
        beta1=args.beta1, beta2=args.beta2,
        max_grad_norm=args.max_grad_norm, warmup_steps=args.warmup_steps,
        use_ema=not args.no_ema, seed=args.seed,
        remat=False if args.remat == "none" else args.remat, mesh=mesh)

    start_step = 0
    if args.resume:
        # any layout the directory holds, onto the one the flags ask for
        step, restored = checkpoint.restore_latest(args.resume, state,
                                                   log=logger.info)
        if restored is not None:
            start_step = step

    host_batch = local_batch_size(args.global_batch_size, world)
    it = None
    if args.synthetic_steps > 0:
        ds = SyntheticCodeDataset(args.global_batch_size * 4,
                                  cfg.block_size, cfg.vocab_size,
                                  cfg.num_classes, seed=args.seed)
        max_steps = args.synthetic_steps
    elif _has(args.code_path, ".codes"):
        # raw shards -> threaded C++ loader (preferred input path)
        from llamagen_tpu_torch.data.native import NativeCodeLoader
        it = NativeCodeLoader(args.code_path, host_batch, seed=args.seed,
                              num_hosts=world, host_id=rank)
        # the loader reshuffles forever: --epochs becomes a step bound
        max_steps = args.max_steps
        if max_steps <= 0 and args.epochs > 0:
            max_steps = min_over_ranks(
                args.epochs * max(it.num_samples // host_batch, 1), device)
    elif _has(args.code_path, (".npz", ".codes.npy")):
        ds = PackedCodeDataset(args.code_path, num_hosts=world, host_id=rank)
        max_steps = args.max_steps
    elif args.code_path:
        # reference {i}.npy micro-file layout: repack once (cached next to
        # the source dir), then memmap the packed shards
        packed = args.code_path.rstrip("/") + "_packed"
        src = NpyCodeDataset(args.code_path,
                             args.label_path or args.code_path)
        if is_main and not _has(packed, ".codes.npy"):
            logger.info(f"repacking {len(src)} npy micro-files -> {packed}")
            pack_shards(src, packed)
        distributed.barrier()
        ds = PackedCodeDataset(packed, num_hosts=world, host_id=rank)
        max_steps = args.max_steps
    else:
        raise SystemExit("need --code-path or --synthetic-steps")

    if it is None and args.synthetic_steps > 0:
        # every rank draws the global batch and keeps its rows
        it = ((rank_rows(c, rank, world), rank_rows(lb, rank, world))
              for c, lb in ds.batches(args.global_batch_size,
                                      seed=args.seed, epochs=args.epochs))
    elif it is None:
        it = ds.batches(host_batch, seed=args.seed, epochs=args.epochs)
    t0, last_log = time.time(), start_step
    running_loss = 0.0
    step = start_step
    ckpt_dir = os.path.join(args.results_dir, "checkpoints")
    profile = contextlib.ExitStack()  # steps 2..4 under `profiling.trace`
    for codes, labels in it:
        if max_steps > 0 and step >= max_steps:
            break
        batch = c2i.Batch(
            labels=torch.from_numpy(np.asarray(labels, np.int64)).to(device),
            tokens=torch.from_numpy(np.asarray(codes, np.int64)).to(device))
        if args.profile_dir and is_main and step == start_step + 2:
            profile.enter_context(profiling.trace(args.profile_dir))
            logger.info(f"profiler trace -> {args.profile_dir}")
        if args.memory_analysis and step == start_step:
            (state, metrics), report = profiling.memory_report(
                step_fn, state, batch, args.seed)
            logger.info(f"first step: {profiling.format_memory(report)}")
        else:
            state, metrics = step_fn(state, batch, args.seed)
        step += 1
        if step == start_step + 5:
            profile.close()
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

    profile.close()  # the run ended inside the profiled steps
    path = checkpoint.save_step(ckpt_dir, step, state)
    if mesh is not None:
        checkpoint.save_full_model(
            os.path.join(ckpt_dir, f"step_{step:08d}_model.pt"), state)
    logger.info(f"done at step {step}; final checkpoint {path}")
    mlog.close()
    return state


if __name__ == "__main__":
    main()
