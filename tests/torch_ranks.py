"""Rank processes for the port's multi-process tests (no JAX here).

`launch(name, world, ...)` spawns `world` processes on the CPU, each with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a
free MASTER_PORT), runs the scenario `name` of this module in each, and
returns every rank's result. A rank that fails fails the launch; a launch
that outlives its timeout is killed and fails.
"""

import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from llamagen_tpu_torch.parallel import distributed  # noqa: E402
from llamagen_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa
from llamagen_tpu_torch.train import c2i, t2i  # noqa: E402
from llamagen_tpu_torch.train import vq as vqt  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _entry(rank, world, port, name, out_dir, args, kwargs):
    os.environ.update(rank_env(rank, world, port))
    torch.set_num_threads(1)
    result = globals()[name](*args, **kwargs)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(name, world, *args, timeout=240, **kwargs):
    """Every rank's return value of `name(*args, **kwargs)`."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _entry, args=(world, free_port(), name, out_dir, args, kwargs),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
                if time.time() > deadline:
                    raise TimeoutError(f"{name} at {world} ranks outlived "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        assert not any(p.is_alive() for p in ctx.processes)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _full_state(state):
    """The whole parameters and EMA of a (sharded) GPT state, by name."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_model_state_dict)
    from torch.distributed.tensor import DTensor
    params = get_model_state_dict(state.model, options=StateDictOptions(
        full_state_dict=True))
    ema = None
    if state.ema is not None:
        ema = {n: e.full_tensor() if isinstance(e, DTensor) else e
               for n, e in state.ema.items()}
    return ({n: p.detach().clone() for n, p in params.items()},
            None if ema is None else {n: e.clone() for n, e in ema.items()})


# --- scenarios ---------------------------------------------------------------


def gpt_steps(cfg, batches, dp=1, fsdp=-1, seed=0, dropout_seed=0,
              vq_cfg=None, vq_weights=None, **kw):
    """c2i (or t2i, given a VQ) steps on `batches` (global numpy batches:
    c2i (labels, tokens); t2i (images, captions, masks, valid)) over a
    (dp, fsdp) mesh: per step the loss and grad norm, then the whole
    parameters and EMA."""
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(dp, fsdp, 1, "cpu")
    if vq_cfg is None:
        state, step = c2i.build_trainer(cfg, "cpu", mesh=mesh, seed=seed,
                                        **kw)
        make = c2i.Batch
    else:
        from llamagen_tpu_torch.models.vq import VQModel
        vq_model = VQModel(vq_cfg, encoder=True)
        vq_model.load_state_dict(vq_weights)
        state, step = t2i.build_trainer(cfg, vq_model, "cpu", mesh=mesh,
                                        seed=seed, **kw)
        make = t2i.T2IBatch
    out = {"loss": [], "grad_norm": [], "wrapped": state.wrapper is not None}
    for b in batches:
        batch = make(*(torch.from_numpy(x) for x in b))
        state, m = step(state, shard_batch(batch), dropout_seed)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    out["params"], out["ema"] = _full_state(state)
    return out


def vq_steps(cfg, loss_cfg, batches, lpips_sd=None, **kw):
    """Data-parallel VQ-GAN steps: per step the metrics and the usage
    window; the first step's gradients; the final parameters."""
    from llamagen_tpu_torch.models import lpips as lpips_lib
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(-1, 1, 1, "cpu")
    lp = None
    if lpips_sd is not None:
        lp = lpips_lib.LPIPS()
        lp.load_state_dict(lpips_sd)
    state, step = vqt.build_trainer(cfg, loss_cfg, torch.device("cpu"),
                                    lpips=lp, mesh=mesh, **kw)
    out = {"metrics": [], "window": []}
    for i, imgs in enumerate(batches):
        state, m = step(state, shard_batch(torch.from_numpy(imgs)))
        out["metrics"].append({k: v.item() for k, v in m.items()})
        out["window"].append(state.usage_window.clone())
        if i == 0:
            out["grads"] = {
                **{f"vq.{n}": p.grad.clone()
                   for n, p in state.model.named_parameters()},
                **{f"disc.{n}": p.grad.clone()
                   for n, p in state.disc.named_parameters()}}
    out["params"] = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
    return out


def checkpointed(cfg, batches, ckpt_dir, dp=1, fsdp=-1, save_at=None,
                 resume=False, export=None, **kw):
    """GPT steps with a DCP save after `save_at` steps, or a resume from
    `ckpt_dir` before the steps; `export`: a whole-model file written at
    the end. Returns the losses, the step count and the whole state."""
    from llamagen_tpu_torch.utils import checkpoint
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(dp, fsdp, 1, "cpu")
    state, step = c2i.build_trainer(cfg, "cpu", mesh=mesh, **kw)
    if resume:
        got, state = checkpoint.restore_latest(ckpt_dir, state)
        assert got is not None
    losses = []
    for b in batches:
        batch = c2i.Batch(*(torch.from_numpy(x) for x in b))
        state, m = step(state, shard_batch(batch), 5)
        losses.append(m["loss"].item())
        if state.step == save_at:
            checkpoint.save_step(ckpt_dir, state.step, state)
    if export:
        checkpoint.save_full_model(export, state)
    params, ema = _full_state(state)
    return {"loss": losses, "step": state.step, "params": params,
            "ema": ema, "opt_steps": _adam_steps(state)}


def _adam_steps(state):
    """The optimizer's step counts (restored with the state)."""
    return sorted({float(s["step"]) for s in
                   state.optimizer.opt.state.values()})


def dropout_draws(cfg, labels, tokens, **kw):
    """One DDP step with every dropout on, every rank given the same rows,
    under remat False and "full": each rank's dropout seed and loss
    (before the mean over ranks) and the parameters after the step."""
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(-1, 1, 1, "cpu")
    batch = c2i.Batch(torch.from_numpy(labels), torch.from_numpy(tokens))
    out = {}
    for remat in (False, "full"):
        seen = {}

        def spy(model, batch, generator, dtype, remat, group):
            seen["seed"] = generator.initial_seed()
            seen["loss"] = c2i.loss_fn(model, batch, generator, dtype, remat,
                                       group)
            return seen["loss"]

        state, step = c2i.build_trainer(cfg, "cpu", mesh=mesh, remat=remat,
                                        compute_dtype=torch.float32,
                                        loss=spy, **kw)
        step(state, batch, 3)
        out[remat] = {"seed": seen["seed"], "loss": seen["loss"].item(),
                      "params": {n: p.detach().clone() for n, p in
                                 state.model.named_parameters()}}
    return out


def image_stream(root, image_size, batch_size, n, seed=0):
    """The first `n` batches of `cli/train_vq.py::image_batches` at this
    rank, under the launcher's process group."""
    from llamagen_tpu_torch.cli.train_vq import image_batches
    assert distributed.init_distributed("cpu")
    it = image_batches(root, image_size, batch_size, seed,
                       distributed.rank(), distributed.world_size())
    return [next(it) for _ in range(n)]


def cli(module, argv):
    """`llamagen_tpu_torch.cli.<module>.main(argv)` in this rank; the
    rank's step count and whether its process group was torn down."""
    import importlib
    main = importlib.import_module(f"llamagen_tpu_torch.cli.{module}").main
    state = main(argv)
    return {"step": state.step, "group_left": dist.is_initialized(),
            "rank": int(os.environ["RANK"])}



def run_cli(module, argv):
    """`llamagen_tpu_torch.cli.<module>.main(argv)`'s return value in this
    rank, under the launcher's environment."""
    import importlib
    return importlib.import_module(
        f"llamagen_tpu_torch.cli.{module}").main(argv)
