"""The port's copies of the JAX package's data and metrics modules
(`llamagen_tpu_torch.data.{codes,native}`, `utils.metrics`) give what the
originals give: the same synthetic codes, packed-shard batches, native
loader batches for a seed, and metrics records."""

import json
import shutil

import numpy as np
import pytest

from llamagen_tpu.data import codes as jcodes
from llamagen_tpu.data import native as jnative
from llamagen_tpu_torch.data import codes, native
from llamagen_tpu_torch.utils.metrics import MetricsLogger


def test_code_datasets_match_jax(tmp_path):
    ds = codes.SyntheticCodeDataset(40, 16, vocab_size=100, num_classes=10,
                                    seed=3)
    jds = jcodes.SyntheticCodeDataset(40, 16, vocab_size=100, num_classes=10,
                                      seed=3)
    np.testing.assert_array_equal(ds.codes, jds.codes)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    assert codes.pack_shards(ds, str(tmp_path / "p"), shard_size=15) == 3
    assert jcodes.pack_shards(jds, str(tmp_path / "j"), shard_size=15) == 3
    mine = codes.PackedCodeDataset(str(tmp_path / "p")).batches(8, seed=1,
                                                                epochs=2)
    ref = jcodes.PackedCodeDataset(str(tmp_path / "j")).batches(8, seed=1,
                                                                epochs=2)
    n = 0
    for (c, lab), (jc, jlab) in zip(mine, ref):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(lab, jlab)
        n += 1
    assert n == 10  # 5 batches of 8 per epoch


def test_native_loader_matches_jax(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available: the native loader cannot build")
    ds = codes.SyntheticCodeDataset(64, 8, seed=2)
    assert native.pack_shards_raw(ds, str(tmp_path), shard_size=40) == 2
    a = native.NativeCodeLoader(str(tmp_path), batch_size=16, seed=7)
    b = jnative.NativeCodeLoader(str(tmp_path), batch_size=16, seed=7)
    assert (a.num_samples, a.seq_len) == (64, 8)
    for _ in range(3):
        (ca, la), (cb, lb) = next(a), next(b)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(la, lb)
    a.close()
    b.close()


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), config={"lr": 1e-4, "dev": object()})
    log.log(3, {"loss": np.float32(2.5), "note": "x"})
    log.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert recs[0]["_config"]["lr"] == 1e-4
    assert recs[1]["step"] == 3 and recs[1]["loss"] == 2.5
    assert recs[1]["note"] == "x"
