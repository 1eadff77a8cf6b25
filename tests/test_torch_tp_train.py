"""The port's tensor-parallel training (`--tp`: `parallel/tp_decode.py`'s
shards and conjugate collectives under `train/c2i.py::build_trainer`,
composed with FSDP2 / DDP over (dp, fsdp)) on the CPU, in gloo ranks
spawned by `tests/torch_ranks.py`, head dim 64, 2 heads a rank, f32.

Held with `tests/test_torch_multiprocess.py`'s tolerances (loss and
grad_norm 1e-5 relative; parameters and EMA after three AdamW steps
within 1 % of the summed learning rate): three steps at (1, 1, 2) and
(1, 2, 2) against JAX's `c2i.build_trainer` on the same mesh of virtual
CPU devices (GSPMD, the Pallas kernel in interpret mode); DDP x TP
(2, 1, 2) against one port process; the rank-0 export in upstream's
[Q | K | V] layout loaded whole by `cli/common.py::load_gpt`; a DCP
checkpoint resumed at the same mesh equals the unbroken run; and with
the dropouts of the activations a rank holds whole on, the TP ranks
equal one process (they draw its masks).
"""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.parallel.mesh import make_mesh as jmake_mesh
from llamagen_tpu.train import c2i as jc2i
from llamagen_tpu_torch.cli.common import load_gpt
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config
from test_torch_multiprocess import (LR_SUM, NANO, OPT, T2I, T2I_VQ,
                                     assert_same_run, c2i_batches,
                                     one_process, random_head, t2i_batches)
from test_torch_multiprocess import one_torch_thread  # noqa: F401 (autouse)
from torch_ranks import launch

# GPT-nano's head dim and depth at 4 heads: 2 a rank at tp 2
TPN = dataclasses.replace(NANO, dim=256, n_head=4)


@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 2, 2)],
                         ids=["tp2", "fsdp2xtp2"])
def test_tp_training_equals_jax_sharded_trainer(mesh):
    """JAX's trainer on the same (dp, fsdp, tp) mesh and the port's ranks
    from JAX's init: three steps of the same global batches (the first
    with lr 0, a clip that triggers); the port recomputes each layer
    (remat "full") with the collectives inside."""
    dp, fsdp, tp = mesh
    world = dp * fsdp * tp
    jcfg = jax_config(TPN)
    jmesh = jmake_mesh(dp, fsdp, tp, devices=jax.devices()[:world])
    jopt = {k: v for k, v in OPT.items() if k != "compute_dtype"}
    jstate, jstep = jc2i.build_trainer(jcfg, jmesh, compute_dtype=jnp.float32,
                                       remat=False, seed=0, **jopt)
    weights = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), TPN)
    batches = c2i_batches(TPN, seed=3)
    ranks = launch("gpt_steps", world, TPN, batches, dp=dp, fsdp=fsdp, tp=tp,
                   remat="full", weights=weights, **OPT)
    ref = {"loss": [], "grad_norm": []}
    for labels, tokens in batches:
        batch = jc2i.shard_batch(jc2i.Batch(jnp.asarray(labels),
                                            jnp.asarray(tokens)), jmesh)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        ref["loss"].append(float(jm["loss"]))
        ref["grad_norm"].append(float(jm["grad_norm"]))
    ref["params"] = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), TPN)
    ref["ema"] = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.ema_params), TPN)
    assert ref["grad_norm"][0] > OPT["max_grad_norm"]  # the clip triggers
    for r, got in enumerate(ranks):
        assert got["wrapped"] == (fsdp == 1 and dp > 1)
        assert_same_run(got, ref, label=f"rank {r} vs JAX")


def test_ddp_by_tp_equals_one_process():
    """(2, 1, 2): DDP over the dp ranks of each TP rank, from a random
    head, against one port process on the same global batches."""
    weights, batches = random_head(TPN), c2i_batches(TPN)
    kw = dict(OPT, remat=False, weights=weights)
    ref = one_process(TPN, batches, **kw)
    ranks = launch("gpt_steps", 4, TPN, batches, dp=2, fsdp=1, tp=2, **kw)
    for r, got in enumerate(ranks):
        assert got["wrapped"]
        assert_same_run(got, ref, label=f"rank {r}")


def test_t2i_ddp_by_tp_equals_one_process():
    """t2i at (2, 1, 2) (the frozen VQ and the caption embedder whole on
    every rank; DDP over each TP rank's dp pair, which looks for the null
    caption's unused gradient), rank 1's data rows holding the only bad
    sample: the update equals one process's global weighted mean."""
    from llamagen_tpu_torch.models import vq
    from llamagen_tpu_torch.train import t2i
    vq_model = vq.init_weights(vq.VQModel(T2I_VQ, encoder=True), seed=1)
    weights = random_head(T2I)
    batches = t2i_batches([1, 0, 1, 1])
    kw = dict(OPT, remat="full", weights=weights)
    ref = one_process(T2I, batches, t2i.T2IBatch, vq_model, **kw)
    ranks = launch("gpt_steps", 4, T2I, batches, dp=2, fsdp=1, tp=2,
                   vq_cfg=T2I_VQ, vq_weights=vq_model.state_dict(), **kw)
    for r, got in enumerate(ranks):
        assert_same_run(got, ref, label=f"rank {r}")


def test_tp_export_loads_whole_and_dcp_resumes(tmp_path):
    """GPT-nano (one head a rank; class dropout, which the ranks and one
    process draw alike), three steps at (1, 1, 2) with a DCP save
    after two; the rank-0 export (TP shards gathered, wqkv in [Q | K | V])
    loads through `load_gpt` and equals one process's parameters; a run
    resumed from the step-2 checkpoint takes step 3 as the unbroken run
    did."""
    cfg = dataclasses.replace(NANO, class_dropout_prob=0.1)  # load_gpt's
    weights, batches = random_head(cfg), c2i_batches(cfg)
    kw = dict(OPT, remat=False, weights=weights)
    ckpt, export = tmp_path / "ckpt", tmp_path / "model.pt"
    full = launch("checkpointed", 2, cfg, batches, str(ckpt), dp=1, fsdp=1,
                  tp=2, save_at=2, export=str(export), **kw)
    resumed = launch("checkpointed", 2, cfg, batches[2:], str(ckpt), dp=1,
                     fsdp=1, tp=2, resume=True, **kw)
    state, step = c2i.build_trainer(cfg, "cpu", **kw)
    for b in batches:  # one process, the same dropout seed
        step(state, c2i.Batch(*(torch.from_numpy(x) for x in b)), 5)
    model = load_gpt(str(export), "GPT-nano", 128, 16, torch.float32, "cpu")
    got = dict(model.named_parameters())
    for name, p in state.model.named_parameters():
        assert torch.equal(got[name], full[0]["params"][name]), name
        err = (got[name] - p).abs().max().item()
        assert err <= 1e-2 * LR_SUM, f"{name}: {err:.3g}"
    for r in range(2):
        assert resumed[r]["step"] == 3 and resumed[r]["opt_steps"] == [3.0]
        np.testing.assert_allclose(resumed[r]["loss"], full[r]["loss"][2:],
                                   rtol=1e-6)
        for name, p in full[r]["params"].items():
            torch.testing.assert_close(resumed[r]["params"][name], p,
                                       rtol=0, atol=1e-7)


def test_tp_ranks_draw_the_same_dropout_masks():
    """Class, token, resid and ffn dropout and drop-path on, at (1, 1, 2):
    the two TP ranks' three steps equal one process's with the same
    dropout seed (loss and grad norm within 1e-5, parameters within 1 % of
    the summed lr). The ranks draw from the data-parallel rank's seed, so
    each rank's masks on the activations it holds whole are one process's;
    a rank drawing other masks would feed its partial sums other inputs
    and move the loss. Attention-probability dropout acts on a rank's own
    heads and draws from a stream offset by the TP rank (Megatron's), so
    it is off here."""
    cfg = dataclasses.replace(TPN, class_dropout_prob=0.1,
                              token_dropout_p=0.1, resid_dropout_p=0.1,
                              ffn_dropout_p=0.1, drop_path_rate=0.1)
    weights, batches = random_head(cfg), c2i_batches(cfg)
    kw = dict(OPT, remat=False, weights=weights)
    ref = one_process(cfg, batches, **kw)
    no_drop = one_process(dataclasses.replace(  # the same null-class row
        cfg, token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
        drop_path_rate=0.0), batches, **kw)
    assert abs(ref["loss"][0] - no_drop["loss"][0]) > 1e-3  # masks bite
    ranks = launch("gpt_steps", 2, cfg, batches, dp=1, fsdp=1, tp=2, **kw)
    for r, got in enumerate(ranks):
        assert_same_run(got, ref, label=f"rank {r}")


def test_train_c2i_cli_at_tp2(tmp_path):
    """`cli/train_c2i.py --tp 2` in two gloo ranks (GPT-nano, 3 synthetic
    steps) with `--profile-dir` and `--memory-analysis` (`utils/
    profiling.py`): both ranks take the steps, rank 0 writes the trace,
    the export loads whole."""
    argv = ["--synthetic-steps", "3", "--gpt-model", "GPT-nano",
            "--image-size", "64", "--global-batch-size", "4", "--tp", "2",
            "--fsdp", "1", "--device", "cpu", "--log-every", "1",
            "--results-dir", str(tmp_path), "--profile-dir",
            str(tmp_path / "trace"), "--memory-analysis"]
    recs = launch("cli", 2, "train_c2i", argv)
    assert [r["step"] for r in recs] == [3, 3]
    assert (tmp_path / "trace" / "trace.json").exists()
    log = (tmp_path / "log.txt").read_text()
    assert "first step: device memory" in log
    model = load_gpt(str(tmp_path / "checkpoints" / "step_00000003_model.pt"),
                     "GPT-nano", 64, 16, torch.float32, "cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_profiling_trace_and_memory_analysis(tmp_path):
    """`trace` writes a Chrome trace on the CPU (a no-op for None);
    `memory_analysis` reports JAX's keys, and on the same function the
    same argument and output bytes as JAX's compiled analysis."""
    from llamagen_tpu.utils import profiling as jprofiling
    from llamagen_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path / "t")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "t" / profiling.TRACE_FILE).stat().st_size > 0
    with profiling.trace(None):
        pass
    got = profiling.memory_analysis(lambda x: x * 2, torch.ones(100))
    want = jprofiling.memory_analysis(lambda x: x * 2, jnp.ones(100))
    assert list(got) == list(want)
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert got[key] == want[key] == 400
    assert got["temp_size_in_bytes"] is None  # the CPU: not measured
    assert "not measured" in profiling.format_memory(got)


def test_entry_loss_and_dryrun():
    """`entry()` (GPT-B bf16, zeroed head) gives ln(vocab); `dryrun(2)` on
    the CPU runs every path across two gloo ranks."""
    from llamagen_tpu_torch import entry
    fn, args = entry.entry("cpu")
    loss = fn(*args).item()
    assert abs(loss - np.log(args[0].cfg.vocab_size)) < 1e-2
    recs = entry.dryrun(2, "cpu")
    assert [r["mesh"] for r in recs] == [(1, 1, 2)] * 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert recs[0]["engine_w4"] == recs[1]["engine_w4"]
