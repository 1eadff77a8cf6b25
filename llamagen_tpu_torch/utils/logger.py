"""Rank-0 logger and experiment directories (PyTorch port of
`llamagen_tpu/utils/logger.py`).

Under a process group only rank 0 logs and picks the experiment
directory, which it broadcasts, as JAX's process 0 does; the other ranks
get a logger without handlers.
"""

from __future__ import annotations

import logging
import os

import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def create_experiment_dir(results_dir: str, model_name: str) -> str:
    """Auto-numbered experiment subdir `{index:03d}-{model}`: the next
    free index in `results_dir`, chosen by rank 0 and broadcast (a listing
    on the other ranks would race rank 0's mkdir)."""
    os.makedirs(results_dir, exist_ok=True)
    index = [0]
    if _rank() == 0:
        existing = [d for d in os.listdir(results_dir)
                    if os.path.isdir(os.path.join(results_dir, d))
                    and d[:3].isdigit()]
        index[0] = 1 + max((int(d[:3]) for d in existing), default=-1)
    if dist.is_initialized():
        dist.broadcast_object_list(index, src=0)
    exp = os.path.join(results_dir,
                       f"{index[0]:03d}-{model_name.replace('/', '-')}")
    os.makedirs(exp, exist_ok=True)
    return exp


def create_logger(logging_dir: str = None,
                  name: str = "llamagen_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    for handler in logger.handlers:  # a run before this one in the process
        handler.close()
    logger.handlers.clear()
    if _rank() != 0:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger
    logger.propagate = True
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logging_dir is not None:
        os.makedirs(logging_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logging_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
