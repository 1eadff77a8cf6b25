"""Run one cell of the benchmark once, on the card this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names its configuration
(`configs/<config>.json`) and traffic mix (`traffic/<mix>.json`, whose
`driver` is `drivers/<driver>.py`); each per-layer metric is read by
`metrics/<metric>.py`. The last line of standard output is the result
object; the numbers compared with their limits close standard error.
Without a CUDA device, with too few of them, or with a JAX module loaded
once the window has closed, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths; keep
# libraries that would load JAX by themselves from doing so
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"JAX modules loaded at start: {found}", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), dev,
                      STARTED)
    result = execute(run)
    if result is None:
        return 2
    print(json.dumps(result))
    return 0


def execute(run) -> "dict | None":
    """The cell's driver on `run`, then the result object (None, with the
    reason on standard error, where a JAX module got loaded)."""
    import importlib

    from perfbench import harness

    driver = importlib.import_module(
        f"perfbench.drivers.{run.cell.traffic['driver']}")
    out = driver.run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX modules loaded by the run: {found}", file=sys.stderr)
        return None
    result = harness.result_line(run.cell, out, run.trace)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(main())
