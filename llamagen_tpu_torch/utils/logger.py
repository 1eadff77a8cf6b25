"""Logger and experiment directories (PyTorch port).

Counterpart of `llamagen_tpu/utils/logger.py` without its process-0 logic
(which asks JAX for the process index): the port trains in one process.
"""

from __future__ import annotations

import logging
import os


def create_experiment_dir(results_dir: str, model_name: str) -> str:
    """Auto-numbered experiment subdir `{index:03d}-{model}`: the next
    free index in `results_dir`."""
    os.makedirs(results_dir, exist_ok=True)
    existing = [d for d in os.listdir(results_dir)
                if os.path.isdir(os.path.join(results_dir, d))
                and d[:3].isdigit()]
    index = 1 + max((int(d[:3]) for d in existing), default=-1)
    exp = os.path.join(results_dir,
                       f"{index:03d}-{model_name.replace('/', '-')}")
    os.makedirs(exp, exist_ok=True)
    return exp


def create_logger(logging_dir: str = None,
                  name: str = "llamagen_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    for handler in logger.handlers:  # a run before this one in the process
        handler.close()
    logger.handlers.clear()
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
