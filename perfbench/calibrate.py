"""The readings the limits of `traffic/<mix>.json` are set from: a cell
run at its own size on many seeds in one process (a short window each),
with the sound program's numbers, the control's (`--control`: the
reference in the precision below the configuration's, int4 weights for
serving, float8 linear layers for training) and a planted fault's
(`--fault`, see `faults.py`).

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 8] [--control] [--fault half]

Prints one JSON line per seed. Needs the card; the benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import importlib

    import torch

    from perfbench import faults, harness

    cell = harness.find_cell(args.workload)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    plant = faults.FAULTS[args.fault] if args.fault else \
        (lambda kind, obj: obj)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        run = harness.Run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), time.time(), plant=plant,
                          extra=("control",) if args.control else ())
        out = driver.run(run)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out.correct, "checks": out.checks,
                          "readings": out.readings,
                          "metrics": out.metrics}), flush=True)
        del out
        harness.free_device(run.device)


if __name__ == "__main__":
    main()
