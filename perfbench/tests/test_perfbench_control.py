"""The control on the card: the reference in the precision below the
configuration's, put in the program's place, fails the cell's limits,
where the sound program passes them. At the cells' widths and depths,
with fewer pairs and a smaller batch than the cells' so that a test run
holds it (the calibration at the cells' own sizes: `perfbench/
calibrate.py`). Card only:

    python -m pytest --noconftest -m cuda \
        perfbench/tests/test_perfbench_control.py
"""

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import serve, train

SEEDS = [2 ** 31 + 11, 2 ** 32 + 12, 2 ** 33 + 13]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def run_of(workload, seed, dev, traffic):
    cell = harness.find_cell(workload, harness.BENCH_DIR / "tests"
                             / "_bench_all.json")
    return harness.Run(cell, seed, 3.0, False, dev, time.time(),
                       shrink={"traffic": traffic}, extra=("control",))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["c2i-l384-serve-capacity"])
def test_serving_control_fails(card, workload, seed):
    out = serve.run(run_of(workload, seed, card,
                           {"pairs": 64, "greedy_every": 8}))
    limit = out.checks["greedy_gap"]["limit"]
    assert out.correct, out.checks
    assert out.readings["control_gap"] > limit, out.readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["c2i-l384-train", "t2i-xl256-train"])
def test_training_control_fails(card, workload, seed):
    out = train.run(run_of(workload, seed, card, {"batch": 8}))
    assert out.correct, out.checks
    ctl = out.readings["control"]
    assert any(ctl[k] > c["limit"] for k, c in out.checks.items()), ctl
