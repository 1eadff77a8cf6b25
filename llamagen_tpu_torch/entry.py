"""Entry points: the training hot path's forward + loss, and a dry run of
every parallel path across ranks (PyTorch counterpart of the repo's
`__graft_entry__.py`).

  python -m llamagen_tpu_torch.entry [--device cuda|cpu] [--ranks N]
                                     [--backend nccl|gloo]

runs `entry()`'s loss, then `dryrun(N)`. JAX's dry run forces N virtual
CPU devices under one controller; here N processes join a gloo (CPU) or
NCCL (one card each) process group, or gloo ranks share the card where
`--backend gloo` asks for it, and each runs `_dryrun_rank`: a sharded c2i
train step on a (dp, fsdp, tp) mesh, CFG `generate`, a TP decode step, the
TP slot engine with bf16, W8A16 and per-shard W4 weights under mixed
per-request sampling, and the one-device speculative engine with a check
that its TP refusal fires.
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from llamagen_tpu_torch.config import GPTConfig, gpt_config
from llamagen_tpu_torch.models import gpt


def entry(device: str = "cuda"):
    """(fn, args): fn(model, labels, tokens) -> the teacher-forced loss of
    the class-conditional GPT-B (bf16) over a 16 x 16 code grid, 4 samples
    (JAX `entry`; upstream train_c2i.py:184-196)."""
    dev = torch.device(device)
    cfg = gpt_config("GPT-B", block_size=256, cls_token_num=1)
    model = gpt.init_weights(gpt.Transformer(cfg, device=dev,
                                             dtype=torch.bfloat16), seed=0)
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(0, cfg.num_classes, (4,), generator=g).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.block_size),
                           generator=g).to(dev)

    @torch.no_grad()
    def fn(model, labels, tokens):
        _, loss = gpt.forward_train(model, labels, tokens[:, :-1],
                                    targets=tokens, train=False,
                                    compute_dtype=torch.bfloat16)
        return loss

    return fn, (model, labels, tokens)


def mesh_dims(n: int):
    """JAX's dry-run mesh for n ranks: tp 2 where n is even, dp 2 where
    that still divides, fsdp the rest."""
    tp = 2 if n % 2 == 0 else 1
    dp = 2 if n % (2 * tp) == 0 and n // tp >= 2 else 1
    return dp, n // (tp * dp), tp


# a small GPT at the kernels' head_dim (64)
DRY_CFG = GPTConfig(dim=256, n_layer=2, n_head=4, block_size=16,
                    num_classes=16, vocab_size=512, cls_token_num=1)


def _model(dev, seed=2):
    m = gpt.init_weights(gpt.Transformer(DRY_CFG, device=dev), seed=seed)
    with torch.no_grad():  # a random head: the reference init zeroes it
        m.output.weight.normal_(0, 0.02, generator=torch.Generator(
            device=dev).manual_seed(seed + 1))
    return m.eval()


def _dryrun_rank(device: str, backend: Optional[str]) -> Dict[str, Any]:
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.parallel import distributed
    from llamagen_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.parallel.tp_decode import (
        quantize_gpt_params_w4k_tp, shard_tp_params)
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
    from llamagen_tpu_torch.serve.spec_engine import SpecEngine
    from llamagen_tpu_torch.train import c2i

    distributed.init_distributed(torch.device(device).type, backend)
    dev = distributed.local_device(torch.device(device))
    n = distributed.world_size()
    dp, fsdp, tp = mesh_dims(n)
    mesh = make_mesh(dp, fsdp, tp, dev.type)
    out: Dict[str, Any] = {"rank": distributed.rank(), "mesh": (dp, fsdp, tp)}

    # the sharded train step
    state, step = c2i.build_trainer(DRY_CFG, dev, mesh=mesh,
                                    compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    b = max(8, n)
    batch = c2i.Batch(torch.randint(0, 16, (b,), generator=g),
                      torch.randint(0, 512, (b, 16), generator=g))
    batch = shard_batch(batch, mesh=mesh)
    _, metrics = step(state, c2i.Batch(batch.labels.to(dev),
                                       batch.tokens.to(dev)), 0)
    out["loss"] = metrics["loss"].item()
    assert torch.isfinite(metrics["loss"]), out["loss"]
    del state

    group, rank = mesh["tp"].get_group(), mesh.get_local_rank("tp")

    def shard(model):
        return shard_tp_params(model, rank, tp, group) if tp > 1 else model

    # CFG sampling on the rank's shard
    f32 = dict(compute_dtype=torch.float32)
    seq = generate(shard(_model(dev)), torch.tensor([1, 2], device=dev),
                   max_new_tokens=16, cfg_scale=2.0,
                   generator=torch.Generator(device=dev).manual_seed(0),
                   cache_dtype=torch.float32, **f32)
    assert seq.shape == (2, 16)
    if tp > 1:
        model = shard(_model(dev))
        cache = gpt.init_cache(DRY_CFG, 2, 128, torch.float32, dev,
                               torch.float32,
                               kv_heads=model.n_local_kv_heads)
        logits = gpt.decode_step(model, torch.zeros(2, dtype=torch.long,
                                                    device=dev), 0, cache,
                                 torch.float32)
        assert logits.shape == (2, DRY_CFG.vocab_size)
        greedy = SamplingParams(cfg_scale=2.0, temperature=0.0)
        for weights in ("bf16", "w8a16", "w4"):
            model = _model(dev)
            if weights == "w8a16":
                quantize_gpt_params(model)
            elif weights == "w4":
                quantize_gpt_params_w4k_tp(model, tp, group_size=64)
            eng = ServeEngine(shard(model), num_pairs=2, max_new_tokens=8,
                              sampling_params=greedy, chunk=4,
                              compute_dtype=torch.bfloat16
                              if weights == "bf16" else torch.float32,
                              mesh=mesh, tp=tp)
            # mixed per-request sampling in one engine
            reqs = [eng.submit(1, sp=SamplingParams(cfg_scale=3.0,
                                                    temperature=0.0)),
                    eng.submit(2, sp=SamplingParams(cfg_scale=1.5,
                                                    temperature=1.0,
                                                    top_k=50)),
                    eng.submit(3)]
            eng.run_until_idle()
            assert all(r.result.shape == (8,) for r in reqs)
            out[f"engine_{weights}"] = [r.result.tolist() for r in reqs]

    # the speculative engine: one device by design; its TP gate fires
    target, draft = _model(dev), _model(dev, seed=5)
    spec = SpecEngine(target, draft, num_pairs=2, max_new_tokens=8, k=2,
                      sampling_params=SamplingParams(cfg_scale=2.0,
                                                     temperature=0.0),
                      compute_dtype=torch.float32)
    assert spec.generate([1, 2]).shape == (2, 8)
    try:
        SpecEngine(target, target, mesh=mesh, tp=max(tp, 2))
        raise AssertionError("the speculative engine's TP gate did not fire")
    except NotImplementedError:
        pass
    distributed.shutdown()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir, device, backend):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    torch.set_num_threads(1)
    torch.save(_dryrun_rank(device, backend),
               os.path.join(out_dir, f"rank{rank}.pt"))


def dryrun(n: int, device: str = "cuda", backend: Optional[str] = None,
           timeout: float = 600) -> List[Dict[str, Any]]:
    """Spawn n ranks (gloo on the CPU; NCCL on cards, or gloo where
    `backend` says so) that run `_dryrun_rank`; every rank's record. A
    rank that fails, or a run past `timeout` seconds, raises."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(n, _free_port(), out_dir, device, backend),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
                if time.time() > deadline:
                    raise TimeoutError(f"the dry run outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        recs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    tp = recs[0]["mesh"][2]
    for r in recs:  # the ranks of a TP group sample the same tokens
        mate = recs[r["rank"] // tp * tp]
        for k in r:
            if k.startswith("engine_"):
                assert r[k] == mate[k], (k, r["rank"])
    print(f"dryrun OK: {n} ranks, mesh (dp, fsdp, tp) = {recs[0]['mesh']}, "
          f"loss {recs[0]['loss']:.4f}, generate, "
          + ("tp decode, tp engine (bf16, w8a16, w4), " if tp > 1 else "")
          + "spec engine (one device; its tp gate fires)")
    return recs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=None,
                   help="default: the cards' count (cuda), 2 (cpu)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device")
    fn, fargs = entry(args.device)
    print(f"entry loss: {fn(*fargs).item():.4f}")
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                       else 2)
    dryrun(n, args.device, args.backend)


if __name__ == "__main__":
    main()
