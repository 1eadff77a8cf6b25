"""A whole run of each cell at its tiny size on the CPU (the look for a
card skipped), once sound and once with the timed path broken
underneath: `correct` has to come out true, then false. The limits are
the tiny size's (its sound numbers are far smaller than the full size's),
each about ten times what a sound tiny run reads."""

import pytest

from perfbench import faults
from perfbench.tests.tiny import tiny_run
from perfbench.drivers import serve, train

BENCH = "perfbench/tests/_bench_all.json"
SERVE_LIMITS = {"greedy_gap": 0.02}
TRAIN_LIMITS = {"loss": 1e-3, "grad_norm": 1e-2, "grad_leaf": 1e-2,
                "change_leaf": 5e-2, "vq_code_gap": 0.2}


@pytest.mark.parametrize("workload", ["c2i-l384-serve-capacity",
                                      "t2i-xl256-serve-capacity"])
@pytest.mark.parametrize("fault", [None, "token"])
def test_serving(workload, fault):
    plant = faults.FAULTS[fault] if fault else (lambda kind, obj: obj)
    out = serve.run(tiny_run(workload, bench=BENCH, plant=plant,
                             limits=SERVE_LIMITS))
    assert out.correct is (fault is None), out.checks


@pytest.mark.parametrize("workload", ["c2i-l384-train", "t2i-xl256-train"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_training(workload, fault):
    plant = faults.FAULTS[fault] if fault else (lambda kind, obj: obj)
    out = train.run(tiny_run(workload, bench=BENCH, plant=plant,
                             limits=TRAIN_LIMITS))
    assert out.correct is (fault is None), out.checks
