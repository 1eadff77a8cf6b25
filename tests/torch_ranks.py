"""Rank processes for the port's multi-process tests (no JAX here).

`launch(name, world, ...)` spawns `world` processes on the CPU, each with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a
free MASTER_PORT), runs the scenario `name` of this module in each, and
returns every rank's result. A rank that fails fails the launch; a launch
that outlives its timeout is killed and fails.
"""

import contextlib
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
    """The whole parameters, EMA and both Adam moments of a (sharded) GPT
    state, by name (TP shards gathered, wqkv in [Q | K | V]), and its
    step."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_model_state_dict)
    from torch.distributed.tensor import DTensor
    from llamagen_tpu_torch.parallel.tp_decode import whole_tp_state

    def whole(d):
        d = {n: t.full_tensor() if isinstance(t, DTensor) else t
             for n, t in d.items()}
        if state.model.tp_size > 1:
            d = whole_tp_state(state.model, d)
        return {n: t.detach().clone() for n, t in d.items()}

    params = get_model_state_dict(state.model, options=StateDictOptions(
        full_state_dict=True))
    if state.model.tp_size > 1:
        params = whole_tp_state(state.model, params)
    name = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer.opt.state
    return {"params": {n: p.detach().clone() for n, p in params.items()},
            "ema": None if state.ema is None else whole(state.ema),
            **{k: whole({name[id(p)]: s[k] for p, s in opt.items()})
               for k in ("exp_avg", "exp_avg_sq")},
            "step": state.step}


@contextlib.contextmanager
def no_gather():
    """Make every gather of a whole sharded tensor raise: the TP gathers
    (`gather_last`, `whole_tp_state`) and DTensor's `full_tensor`."""
    from torch.distributed.tensor import DTensor
    from llamagen_tpu_torch.parallel import collectives, tp_decode
    from llamagen_tpu_torch.utils import checkpoint

    def refuse(*args, **kwargs):
        raise AssertionError("a whole sharded tensor was gathered")

    where = [(collectives, "gather_last"), (tp_decode, "gather_last"),
             (tp_decode, "whole_tp_state"), (checkpoint, "whole_tp_state"),
             (DTensor, "full_tensor")]
    saved = [getattr(obj, attr) for obj, attr in where]
    for obj, attr in where:
        setattr(obj, attr, refuse)
    try:
        yield
    finally:
        for (obj, attr), fn in zip(where, saved):
            setattr(obj, attr, fn)


# --- scenarios ---------------------------------------------------------------


def gpt_steps(cfg, batches, dp=1, fsdp=-1, seed=0, dropout_seed=0,
              vq_cfg=None, vq_weights=None, tp=1, **kw):
    """c2i (or t2i, given a VQ) steps on `batches` (global numpy batches:
    c2i (labels, tokens); t2i (images, captions, masks, valid)) over a
    (dp, fsdp, tp) mesh: per step the loss and grad norm, then the whole
    parameters and EMA."""
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(dp, fsdp, tp, "cpu")
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
        state, m = step(state, shard_batch(batch, mesh=mesh), dropout_seed)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    out.update(_full_state(state))
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


def _gpt_trainer(cfg, mesh, vq_cfg=None, vq_weights=None, **kw):
    """(state, step, batch type) of the c2i trainer, or of the t2i one
    given a VQ."""
    if vq_cfg is None:
        return (*c2i.build_trainer(cfg, "cpu", mesh=mesh, **kw), c2i.Batch)
    from llamagen_tpu_torch.models.vq import VQModel
    vq_model = VQModel(vq_cfg, encoder=True)
    vq_model.load_state_dict(vq_weights)
    return (*t2i.build_trainer(cfg, vq_model, "cpu", mesh=mesh, **kw),
            t2i.T2IBatch)


def checkpointed(cfg, batches, ckpt_dir, dp=1, fsdp=-1, save_at=None,
                 resume=False, export=None, tp=1, resume_at=None,
                 vq_cfg=None, vq_weights=None, **kw):
    """GPT steps (t2i given a VQ) at (dp, fsdp, tp) with a save after
    `save_at` steps, or a resume from `ckpt_dir` before the steps (the
    save and the restore run under `no_gather`); `export`: a whole-model
    file written at the end. Returns the losses, grad norms, the step
    count and the whole state, the whole state just after the save
    ("saved") or the restore ("loaded"), and with `resume_at` (dp, fsdp,
    tp) also "resumed": a second run at that layout, resumed from the
    save, over the steps after it."""
    from llamagen_tpu_torch.utils import checkpoint
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(dp, fsdp, tp, "cpu")
    state, step, make = _gpt_trainer(cfg, mesh, vq_cfg, vq_weights, **kw)
    out = {"loss": [], "grad_norm": []}
    if resume:
        with no_gather():
            got, state = checkpoint.restore_latest(ckpt_dir, state)
        assert got is not None
        out["loaded"] = _full_state(state)
    for b in batches:
        batch = make(*(torch.from_numpy(x) for x in b))
        state, m = step(state, shard_batch(batch, mesh=mesh), 5)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        if state.step == save_at:
            with no_gather():
                checkpoint.save_step(ckpt_dir, state.step, state)
            out["saved"] = _full_state(state)
    if export:
        checkpoint.save_full_model(export, state)
    out.update(_full_state(state), opt_steps=_adam_steps(state))
    if resume_at is not None:
        r_dp, r_fsdp, r_tp = resume_at
        out["resumed"] = checkpointed(
            cfg, batches[save_at:], ckpt_dir, r_dp, r_fsdp, resume=True,
            tp=r_tp, vq_cfg=vq_cfg, vq_weights=vq_weights, **kw)
    return out


def runs(jobs):
    """Each job (scenario name, kwargs) of this module in turn, in one
    process group (each at its own mesh over every rank)."""
    return [globals()[name](**kw) for name, kw in jobs]


def tp_layout(cases):
    """Each case (cfg, whole state dict, tp): this rank's TP shard of the
    model in the group of the `tp` adjacent ranks it belongs to, its local
    state dict, the pieces `tp_pieces` gives each entry and
    `whole_tp_state` of the shard."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.parallel.tp_decode import (shard_tp_params,
                                                       tp_pieces,
                                                       whole_tp_state)
    assert distributed.init_distributed("cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for cfg, sd, tp in cases:
        groups = [dist.new_group(list(range(g, g + tp)))
                  for g in range(0, world, tp)]
        model = gpt.Transformer(cfg)
        model.load_state_dict(sd)
        shard_tp_params(model, rank % tp, tp, groups[rank // tp])
        local = {k: v.clone() for k, v in model.state_dict().items()}
        out.append({"local": local,
                    "pieces": {k: tp_pieces(k, cfg, tp, rank % tp, v.shape)
                               for k, v in local.items()},
                    "whole": whole_tp_state(model, model.state_dict())})
    return out


def refused_layout(argv):
    """`cli/train_c2i.py` with `argv` (a layout the model cannot take and a
    `--resume`): the error it raises and whether any checkpoint was read
    first."""
    from llamagen_tpu_torch.cli import train_c2i
    from llamagen_tpu_torch.utils import checkpoint
    loads = []
    restore = checkpoint.restore_latest
    checkpoint.restore_latest = lambda *a, **k: loads.append(a) or restore(
        *a, **k)
    try:
        train_c2i.main(argv)
    except ValueError as e:
        return {"error": str(e), "loads": len(loads)}
    finally:
        checkpoint.restore_latest = restore
    return {"error": None, "loads": len(loads)}


def vq_checkpointed(cfg, loss_cfg, batches, ckpt_dir, lpips_sd=None, **kw):
    """A data-parallel VQ-GAN run resumed from `ckpt_dir` (under
    `no_gather`): the whole state just after the restore, then per step
    the metrics, and the parameters after the steps."""
    from llamagen_tpu_torch.models import lpips as lpips_lib
    from llamagen_tpu_torch.utils import checkpoint
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(-1, 1, 1, "cpu")
    lp = None
    if lpips_sd is not None:
        lp = lpips_lib.LPIPS()
        lp.load_state_dict(lpips_sd)
    state, step = vqt.build_trainer(cfg, loss_cfg, torch.device("cpu"),
                                    lpips=lp, mesh=mesh, **kw)
    with no_gather():
        got, state = checkpoint.restore_latest(ckpt_dir, state)
    out = {"loaded": vq_whole_state(state), "metrics": []}
    for imgs in batches:
        state, m = step(state, shard_batch(torch.from_numpy(imgs)))
        out["metrics"].append({k: v.item() for k, v in m.items()})
    out["window"] = state.usage_window.clone()
    out["params"] = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
    return out


def vq_whole_state(state):
    """A VQ-GAN state's parameters, Adam moments (both models, by name),
    EMA, usage window and step."""
    out = {"step": state.step, "window": state.usage_window.clone(),
           "ema": {n: e.clone() for n, e in (state.ema or {}).items()}}
    for key, model, opt in (("vq", state.model, state.optimizer),
                            ("disc", state.disc, state.disc_optimizer)):
        name = {id(p): n for n, p in model.named_parameters()}
        out[key] = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{key}_{k}"] = {name[id(p)]: s[k].clone()
                                 for p, s in opt.opt.state.items()}
    return out


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


# --- tensor parallelism -------------------------------------------------------


def _tp_model(case, tp, rank, group):
    """The case's whole model (its state dict), quantised as it asks
    ("int8": W8A16 layers; "w4": per-shard W4), then rank `rank`'s shard."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.parallel.tp_decode import (
        quantize_gpt_params_w4k_tp, shard_tp_params)
    model = gpt.Transformer(case["cfg"])
    model.load_state_dict(case["sd"])
    if case.get("quant") == "int8":
        quantize_gpt_params(model)
    elif case.get("quant") == "w4":
        quantize_gpt_params_w4k_tp(model, tp, group_size=case["group_size"])
    return shard_tp_params(model.eval(), rank, tp, group)


def tp_cases(cases):
    """Each case on a (1, 1, world) mesh: "engine" runs `ServeEngine(tp=)`
    on `case["requests"]` (labels, or (caption, mask) pairs, each with
    optional SamplingParams kwargs) and returns the tokens in submission
    order; "decode" runs `gpt.decode_step` on the shard over
    `case["tokens"]` [steps, B] from an empty cache of the shard's width in
    `case["dtype"]` (compute and cache; f32 by default) and returns each
    step's logits."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    assert distributed.init_distributed("cpu")
    mesh = make_mesh(1, 1, -1, "cpu")
    tp, rank = mesh["tp"].size(), mesh.get_local_rank("tp")
    out = {}
    for name, case in cases.items():
        model = _tp_model(case, tp, rank, mesh["tp"].get_group())
        if case["kind"] == "decode":
            dtype = case.get("dtype", torch.float32)
            toks = torch.from_numpy(case["tokens"])
            cache = gpt.init_cache(model.cfg, toks.shape[1], 128, dtype,
                                   "cpu", dtype,
                                   kv_heads=model.n_local_kv_heads)
            out[name] = np.stack([
                gpt.decode_step(model, t, i, cache, dtype).numpy()
                for i, t in enumerate(toks)])
            continue
        eng = ServeEngine(model, mesh=mesh, tp=tp, chunk=4,
                          sampling_params=SamplingParams(**case["sp"]),
                          **case["engine"])
        reqs = []
        for req, sp in case["requests"]:
            sp = None if sp is None else SamplingParams(**sp)
            reqs.append(eng.submit_caption(*req, sp=sp)
                        if isinstance(req, tuple) else eng.submit(req, sp=sp))
        eng.run_until_idle()
        out[name] = np.stack([r.result for r in reqs])
    return out



def tp_engine_on_card(cfg, sd):
    """One of two gloo ranks sharing the card: rank r's TP shard of the
    model `sd` (bf16, W8A16 layers) serves four labels with an int8 cache;
    returns (the engine's graphed share, the graphs it captured, the
    tokens)."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.parallel.tp_decode import shard_tp_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    assert distributed.init_distributed("cuda", "gloo")
    mesh = make_mesh(1, 1, -1, "cuda")
    tp, rank = mesh["tp"].size(), mesh.get_local_rank("tp")
    model = gpt.Transformer(cfg)
    model.load_state_dict(sd)
    model = quantize_gpt_params(model.to("cuda", torch.bfloat16).eval())
    model = shard_tp_params(model, rank, tp, mesh["tp"].get_group())
    eng = ServeEngine(model, mesh=mesh, tp=tp, num_pairs=2,
                      max_new_tokens=cfg.block_size, chunk=8,
                      compute_dtype=torch.bfloat16, cache_dtype=torch.int8,
                      sampling_params=SamplingParams(temperature=0.0))
    tokens = eng.generate([3, 7, 11, 19])
    return (eng.stats()["decode_graphed_share"],
            len(eng.step_fn.graphs._graphs), tokens)
