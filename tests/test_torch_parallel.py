"""The port's `parallel/` modules in one process: the mesh shape (JAX's
-1 absorption and its errors), the launcher environments, this rank's
rows of a batch and of the data loaders, the per-rank dropout seed, the
global norm over shards, the BatchNorm's group, and the checkpoint
directory's names. The runs across ranks are in
`tests/test_torch_multiprocess.py`."""

import os
import shutil

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.data.codes import PackedCodeDataset
from llamagen_tpu_torch.models import discriminator as disc_lib
from llamagen_tpu_torch.parallel import distributed, mesh
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.train.train_state import global_norm
from llamagen_tpu_torch.utils import checkpoint


@pytest.mark.parametrize("dp,fsdp,world,want", [
    (1, -1, 4, (1, 4)), (-1, 1, 4, (4, 1)), (2, -1, 4, (2, 2)),
    (-1, 2, 8, (4, 2)), (2, 2, 4, (2, 2)), (1, 1, 1, (1, 1)),
    (-1, 1, 1, (1, 1))])
def test_mesh_shape_absorbs_the_rest(dp, fsdp, world, want):
    assert mesh.mesh_shape(dp, fsdp, 1, world) == want + (1,)


@pytest.mark.parametrize("dp,fsdp,world", [
    (2, -1, 3), (2, 2, 8), (-1, -1, 4), (2, 1, 1), (1, 4, 1), (0, -1, 2)])
def test_mesh_shape_refuses_a_mesh_that_is_not_the_world(dp, fsdp, world):
    with pytest.raises(ValueError):
        mesh.mesh_shape(dp, fsdp, 1, world)


def test_tensor_parallel_training_is_refused():
    """A TP degree is refused where the world cannot hold it; where it
    can, tp is the mesh's third axis and -1 absorbs the rest around it."""
    for dp, fsdp, tp, world in ((1, -1, 3, 4), (1, 1, 2, 1), (-1, 2, 2, 6),
                                (1, -1, -1, 4)):
        with pytest.raises(ValueError):
            mesh.mesh_shape(dp, fsdp, tp, world)
    assert mesh.mesh_shape(1, -1, 2, 2) == (1, 1, 2)
    assert mesh.mesh_shape(-1, 2, 2, 8) == (2, 2, 2)
    assert mesh.mesh_shape(1, 1, -1, 4) == (1, 1, 4)


TORCHRUN = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
            "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}


@pytest.mark.parametrize("env,want", [
    (TORCHRUN, ("3", "8", "1", "10.0.0.1", "1234")),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0",
      "MASTER_ADDR": "node0"}, ("2", "4", "0", "node0", "29500")),
    ({**TORCHRUN, "SLURM_NTASKS": "4", "SLURM_PROCID": "2"},
     ("3", "8", "1", "10.0.0.1", "1234")),  # torchrun inside SLURM
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0", "MASTER_ADDR": "node0"},
     None),  # a single-task SLURM job is one process
    ({}, None)], ids=["torchrun", "slurm", "torchrun-in-slurm",
                      "slurm-one-task", "none"])
def test_launch_env(env, want):
    got = distributed.launch_env(env)
    if want is None:
        assert got is None
    else:
        assert tuple(got[k] for k in ("rank", "world_size", "local_rank",
                                      "master_addr", "master_port")) == want


def test_multi_task_slurm_needs_the_first_node():
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.launch_env({"SLURM_NTASKS": "2", "SLURM_PROCID": "1"})


def test_one_process_makes_no_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(key, raising=False)
    assert not distributed.init_distributed("cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_main_process()


def test_shard_batch_takes_the_rank_stride():
    batch = c2i.Batch(labels=torch.arange(6),
                      tokens=torch.arange(12).reshape(6, 2))
    parts = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    assert parts[1].labels.tolist() == [1, 4] and parts[1].valid is None
    assert parts[2].tokens.tolist() == [[4, 5], [10, 11]]
    # interleaving the ranks' rows gives the global batch back
    rows = torch.stack([p.labels for p in parts], dim=1).reshape(-1)
    assert torch.equal(rows, batch.labels)
    assert mesh.shard_batch(batch, 0, 1) is batch
    with pytest.raises(ValueError, match="divide"):
        mesh.local_batch_size(10, 4)
    assert mesh.local_batch_size(12, 4) == 3


def test_packed_loader_ranks_hold_the_global_batch(tmp_path):
    """With `num_hosts` = world and `host_id` = rank, each rank's batch of
    global // world rows is its stride of the one-process batch, and the
    ranks take as many batches each (an odd dataset drops its last row)."""
    n, length, world, global_batch = 23, 5, 2, 4
    codes = np.arange(n * length, dtype=np.int32).reshape(n, length)
    np.save(tmp_path / "s0.codes.npy", codes)
    np.save(tmp_path / "s0.labels.npy", np.arange(n, dtype=np.int32))
    one = list(PackedCodeDataset(str(tmp_path)).batches(
        global_batch, seed=7, epochs=1))
    ranks = [list(PackedCodeDataset(str(tmp_path), num_hosts=world,
                                    host_id=r).batches(
        global_batch // world, seed=7, epochs=1)) for r in range(world)]
    assert len(ranks[0]) == len(ranks[1]) == 5
    for step, (codes_g, labels_g) in enumerate(one):
        for r in range(world):
            np.testing.assert_array_equal(ranks[r][step][1],
                                          labels_g[r::world])
            np.testing.assert_array_equal(ranks[r][step][0],
                                          codes_g[r::world])


def test_rank_seed_is_the_seed_at_one_rank():
    assert c2i.rank_seed(5, 0, 1) == 5
    seeds = {c2i.rank_seed(s, r, 4) for s in range(3) for r in range(4)}
    assert len(seeds) == 12  # every (seed, rank) its own stream


def test_global_norm_over_shards_equals_the_whole():
    """The sums run in f64: split rows (as FSDP2 shards a gradient) give
    the whole tensor's norm to f32 rounding, and the f64 truth."""
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(16384, 128, generator=g) * 1e-3
    small = torch.randn(128, generator=g)
    full = global_norm([whole, small]).item()
    halves = [torch.linalg.vector_norm(h, dtype=torch.float64) ** 2
              for h in whole.chunk(2)]
    split = float(torch.sqrt(sum(halves) + small.double().norm() ** 2))
    truth = float(torch.sqrt(whole.double().norm() ** 2
                             + small.double().norm() ** 2))
    assert abs(full / truth - 1) < 1e-6 and abs(split / truth - 1) < 1e-6
    assert global_norm([whole]).dtype == torch.float32


def test_use_global_batch_sets_every_batchnorm():
    disc = disc_lib.make_discriminator("patchgan", 32)
    bns = [m for m in disc.modules() if isinstance(m, disc_lib.BatchNorm2d)]
    assert len(bns) == 3 and all(m.group is None for m in bns)
    x = torch.randn(2, 32, 32, 3)
    before = disc(x)
    marker = object()
    disc_lib.use_global_batch(disc, marker)
    assert all(m.group is marker for m in bns)
    disc_lib.use_global_batch(disc, None)
    assert torch.equal(disc(x), before)


def test_latest_step_finds_files_and_dcp_directories(tmp_path):
    (tmp_path / "step_00000003.pt").write_bytes(b"")
    (tmp_path / "step_00000005").mkdir()
    (tmp_path / "step_00000005" / ".metadata").write_bytes(b"")
    for other in ("step_00000007_model.pt", "step_00000009.pt.tmp"):
        (tmp_path / other).write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path)) == 5
    shutil.rmtree(tmp_path / "step_00000005")
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_latest_step_skips_an_interrupted_dcp_save(tmp_path):
    """A DCP directory without `.metadata` (a save cut before its end)
    is not a checkpoint: the newest complete one is resumed from."""
    (tmp_path / "step_00000004").mkdir()
    (tmp_path / "step_00000004" / ".metadata").write_bytes(b"")
    (tmp_path / "step_00000006").mkdir()
    (tmp_path / "step_00000006" / "__0_0.distcp").write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path)) == 4
    (tmp_path / "step_00000004" / ".metadata").unlink()
    assert checkpoint.latest_step(str(tmp_path)) is None
