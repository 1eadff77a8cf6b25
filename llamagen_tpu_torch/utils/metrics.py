"""Experiment metrics stream: JSONL always, wandb opt-in.

The port's own copy of `llamagen_tpu/utils/metrics.py`. The primary sink
is an append-only `metrics.jsonl` in the experiment dir (one JSON object
per log call; it survives crashes); when the `wandb` package is importable
AND the caller opts in, the same records mirror to a wandb run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Rank-0 scalar-metrics sink (JSONL file + optional wandb mirror)."""

    def __init__(self, exp_dir: str, *, use_wandb: bool = False,
                 project: str = "llamagen_tpu",
                 config: Optional[Dict[str, Any]] = None,
                 is_main: bool = True):
        self._is_main = is_main
        self._fh = None
        self._wandb = None
        if not is_main:
            return
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(
                    project=project, name=os.path.basename(exp_dir) or None,
                    config=config or {}, dir=exp_dir)
            except Exception:
                # wandb missing or no service reachable: JSONL still records
                self._wandb = None
        if config:
            self._fh.write(json.dumps(
                {"_config": {k: _jsonable(v) for k, v in config.items()},
                 "time": time.time()}) + "\n")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=int(step))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)
