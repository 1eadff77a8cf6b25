"""What the benchmark loads and writes. A tiny run of each cell on the CPU
in a process of its own loads no module whose top-level name is JAX's
or the JAX package's (compared whole: the port's `llamagen_tpu_torch`
begins with `llamagen_tpu`), and writes nothing to /tmp or /dev/shm
(only the checkout, HOME, XDG_CACHE_HOME and TMPDIR); the reference and
the counts load nothing of the program; a checkout of the benchmark's
files alone, or a machine without a card, gives no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
CELLS = ["c2i-l384-serve-capacity", "t2i-xl256-serve-capacity",
         "c2i-l384-train", "t2i-xl256-train"]
TINY = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness, run
from perfbench.tests.tiny import tiny_run
res = run.execute(tiny_run({cell!r}, trace={trace}, bench={bench!r}))
assert res is not None and res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def listing(path):
    try:
        return set(os.listdir(path))
    except FileNotFoundError:
        return set()


def env_with_own_dirs(tmp_path):
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        d = tmp_path / var.lower()
        d.mkdir()
        env[var] = str(d)
    return env


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax_and_writes_only_its_own_dirs(cell, trace,
                                                          tmp_path):
    before = (listing("/tmp"), listing("/dev/shm"))
    code = TINY.format(root=str(ROOT), cell=cell, trace=trace,
                       bench="perfbench/tests/_bench_all.json")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env_with_own_dirs(tmp_path), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN)
    assert "llamagen_tpu_torch" in loaded  # the name is not caught
    new = (listing("/tmp") - before[0]) | (listing("/dev/shm") - before[1])
    assert not {n for n in new if not n.startswith("pytest-of-")}, new


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("llamagen_tpu_torch", sys.modules[__name__])
    assert "llamagen_tpu_torch" not in harness.forbidden_modules()


def test_reference_and_counts_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.gpt, perfbench.reference.vq, "
            "perfbench.counts, perfbench.weights; "
            "print(sorted(m for m in sys.modules if m.startswith('llamagen')))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_fixed_temporary_paths_in_the_sources():
    for p in harness.BENCH_DIR.rglob("*.py"):
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, p


@pytest.mark.parametrize("alone", [False, True])
def test_no_card_or_no_program_gives_no_result(alone, tmp_path):
    root = ROOT
    if alone:  # the benchmark's files alone
        root = tmp_path / "checkout"
        root.mkdir()
        shutil.copy(ROOT / "BENCHMARK.json", root)
        shutil.copytree(ROOT / "perfbench", root / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "c2i-l384-train", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=root, env=env_with_own_dirs(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
