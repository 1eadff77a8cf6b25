"""Process groups for training across GPUs (PyTorch port of
`llamagen_tpu/parallel/distributed.py`).

JAX finds its processes with `jax.distributed.initialize()`; here the
launcher's environment names them: torchrun's `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`, or a SLURM job's
`SLURM_PROCID`, `SLURM_NTASKS` and `SLURM_LOCALID` (with `MASTER_ADDR`
and, by default, port 29500), as upstream's `utils/distributed.py` reads
them. A single-task SLURM job and a plain `python -m ...` run are one
process: no group is made, and the trainers take their one-process path.
Under torchrun the group is made even at world size 1, so one card runs
the sharded code.

On CUDA each rank takes the card `LOCAL_RANK` (set before anything
touches a card) and NCCL; with `backend="gloo"` ranks may share a card
(rank `LOCAL_RANK % device_count`). On the CPU the backend is gloo.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist


def launch_env(environ: Optional[Dict[str, str]] = None
               ) -> Optional[Dict[str, str]]:
    """(rank, world size, local rank, master address, master port) as
    strings from torchrun's or a multi-task SLURM job's variables; None for
    one process (no launcher, or SLURM with one task)."""
    env = os.environ if environ is None else environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return {"rank": env["RANK"], "world_size": env["WORLD_SIZE"],
                "local_rank": env.get("LOCAL_RANK", "0"),
                "master_addr": env.get("MASTER_ADDR", "127.0.0.1"),
                "master_port": env.get("MASTER_PORT", "29500")}
    if int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        if "MASTER_ADDR" not in env:
            raise RuntimeError("a multi-task SLURM job needs MASTER_ADDR "
                               "(the first node's address)")
        return {"rank": env["SLURM_PROCID"],
                "world_size": env["SLURM_NTASKS"],
                "local_rank": env.get("SLURM_LOCALID", "0"),
                "master_addr": env["MASTER_ADDR"],
                "master_port": env.get("MASTER_PORT", "29500")}
    return None


def init_distributed(device_type: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Join the launcher's process group; True when distributed. A group
    made before (by this function or the caller) is kept. On CUDA the rank
    takes its card first (`local_device`); the backend defaults to NCCL
    on CUDA and gloo on the CPU."""
    if dist.is_initialized():
        return True
    env = launch_env()
    if env is None:
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(_card(int(env["local_rank"]), backend))
    dist.init_process_group(
        backend, init_method=f"tcp://{env['master_addr']}:"
                             f"{env['master_port']}",
        rank=int(env["rank"]), world_size=int(env["world_size"]))
    return True


def _card(local_rank: int, backend: str) -> int:
    count = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= count:
        raise RuntimeError(f"local rank {local_rank} has no card of its own "
                           f"({count} visible); NCCL refuses two ranks on "
                           f"one card (gloo takes them)")
    return local_rank % count


def local_device(device: torch.device) -> torch.device:
    """This rank's device: the card `init_distributed` set on CUDA."""
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Wait for every rank, then tear the group down (the CLIs' exit)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
