"""Training checkpoints across layouts (`llamagen_tpu_torch/utils/
checkpoint.py`, `parallel/tp_decode.py::tp_pieces`) on the CPU, in gloo
ranks spawned by `tests/torch_ranks.py`, f32.

A state saved at one (dp, fsdp, tp), or by one process as a `.pt`, resumes
at another layout: (1, 1, 2) -> one process and -> (1, 2, 1); (1, 2, 1) ->
(1, 1, 2); (1, 2, 2) -> (2, 1, 1); a `.pt` -> (1, 1, 2) and -> (1, 2, 1),
for GPT-nano and a GQA config (8 heads over 4 kv heads); a t2i state
(1, 1, 2) -> (1, 2, 1); a VQ-GAN `.pt` -> dp 2. Each resume's state, made
whole, equals the saved one bit for bit (parameters, both Adam moments,
EMA, step; the VQ-GAN's usage window), and its next step equals the
unbroken run's within `tests/test_torch_multiprocess.py`'s bounds across
layouts (loss and grad norm 1e-5 relative, parameters and EMA within 1 %
of the summed learning rate; the VQ-GAN's metrics 3e-4 relative, its
parameters within 1 % of lr where the gradient is large, 2 lr elsewhere).
Saves and restores run with every gather of a whole sharded tensor made
to raise (`torch_ranks.no_gather`); a DCP directory takes at most 1.05 x
the bytes of the same state's `.pt`. Every save serves several resumes:
one four-rank and one two-rank launch in all.
"""

import os
import pathlib
import tempfile

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from llamagen_tpu_torch.cli import train_c2i
from llamagen_tpu_torch.config import replace
from llamagen_tpu_torch.models import gpt, vq
from llamagen_tpu_torch.models import lpips as lpips_lib
from llamagen_tpu_torch.parallel import tp_decode
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.train import vq as vqt
from llamagen_tpu_torch.utils import checkpoint
from test_torch_multiprocess import (NANO, OPT, T2I, T2I_VQ, VQ_CFG,
                                     VQ_LR, GRAD_TOL, assert_same_run,
                                     c2i_batches, random_head, t2i_batches,
                                     vq_images)
from test_torch_multiprocess import one_torch_thread  # noqa: F401 (autouse)
from torch_ranks import _full_state, launch, no_gather, vq_whole_state

# 8 query heads over 4 kv heads: whole kv heads a rank at tp 2 and 4
GQA = replace(NANO, dim=256, n_head=8, n_kv_head=4, vocab_size=4096)
CFGS = {"nano": NANO, "gqa": GQA}
SAVE_AT = 2
KW = dict(OPT, remat=False)
VQ_KW = dict(lr=VQ_LR, use_ema=True, ema_decay=0.9)
VQ_LOSS = vqt.VQLossConfig(disc_start=0, disc_adaptive_weight=True,
                           image_size=32)


def _one_process(cfg, batches, ckpt_dir, **kw):
    """One process's steps with a `.pt` save after SAVE_AT: the whole state
    at the save, each step's loss and grad norm, the final state."""
    state, step = c2i.build_trainer(cfg, "cpu", **kw)
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        state, m = step(state, c2i.Batch(*(torch.from_numpy(x) for x in b)),
                        5)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        if state.step == SAVE_AT:
            checkpoint.save_step(ckpt_dir, state.step, state)
            out["saved"] = _full_state(state)
    out.update(_full_state(state))
    return out


def _vq_one_process(batches, ckpt_dir, lp):
    """The VQ-GAN in one process with a `.pt` save after SAVE_AT: the
    whole state at the save; the metrics, gradients, window and
    parameters of the step after it."""
    state, step = vqt.build_trainer(VQ_CFG, VQ_LOSS, torch.device("cpu"),
                                    lpips=lp, **VQ_KW)
    out = {}
    for x in batches:
        state, m = step(state, torch.from_numpy(x))
        if state.step == SAVE_AT:
            checkpoint.save_vq_step(ckpt_dir, state.step, state)
            out["saved"] = vq_whole_state(state)
    out["metrics"] = {k: v.item() for k, v in m.items()}
    out["grads"] = {n: p.grad.clone()
                    for n, p in state.model.named_parameters()}
    out["window"] = state.usage_window.clone()
    out["params"] = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
    return out


def _bytes(path):
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


@pytest.fixture(scope="module")
def runs():
    """Every save and resume of this file: the one-process runs here, the
    (1, 2, 2) saves, the layout map and the refused tp in four ranks,
    every other save and resume in two (the checkpoints, some 600 MB, are
    removed after the module)."""
    with tempfile.TemporaryDirectory() as root:
        yield _runs(pathlib.Path(root))


def _runs(tmp):
    d = {k: str(tmp / k) for k in ("pt_vq", "t2i", "cli")}
    out = {"dirs": d, "cfg": {}}
    jobs4, jobs2 = [], []
    for name, cfg in CFGS.items():
        kw = dict(KW, weights=random_head(cfg))
        batches = c2i_batches(cfg)
        for k in ("pt", "tp2", "fsdp2", "fsdp2xtp2"):
            d[f"{k}_{name}"] = str(tmp / f"{k}_{name}")
        out["cfg"][name] = {"one": _one_process(cfg, batches,
                                                d[f"pt_{name}"], **kw)}
        common = dict(cfg=cfg, **kw)
        jobs4.append(("checkpointed", dict(
            common, batches=batches, ckpt_dir=d[f"fsdp2xtp2_{name}"],
            dp=1, fsdp=2, tp=2, save_at=SAVE_AT)))
        rest = batches[SAVE_AT:]
        jobs2 += [
            ("checkpointed", dict(common, batches=batches,
                                  ckpt_dir=d[f"tp2_{name}"], dp=1, fsdp=1,
                                  tp=2, save_at=SAVE_AT,
                                  resume_at=(1, 2, 1))),
            ("checkpointed", dict(common, batches=batches,
                                  ckpt_dir=d[f"fsdp2_{name}"], dp=1, fsdp=2,
                                  tp=1, save_at=SAVE_AT,
                                  resume_at=(1, 1, 2))),
            ("checkpointed", dict(common, batches=rest,
                                  ckpt_dir=d[f"fsdp2xtp2_{name}"], dp=2,
                                  fsdp=1, tp=1, resume=True)),
            ("checkpointed", dict(common, batches=rest,
                                  ckpt_dir=d[f"pt_{name}"], dp=1, fsdp=1,
                                  tp=2, resume=True)),
            ("checkpointed", dict(common, batches=rest,
                                  ckpt_dir=d[f"pt_{name}"], dp=1, fsdp=2,
                                  tp=1, resume=True))]
    out["weights"] = {name: random_head(cfg) for name, cfg in CFGS.items()}
    jobs4.append(("tp_layout", dict(cases=[
        (NANO, out["weights"]["nano"], 2), (GQA, out["weights"]["gqa"], 2),
        (GQA, out["weights"]["gqa"], 4)])))
    cli = ["--synthetic-steps", "3", "--gpt-model", "GPT-nano",
           "--image-size", "64", "--global-batch-size", "4", "--device",
           "cpu", "--log-every", "1"]
    jobs4.append(("refused_layout", dict(argv=cli + [
        "--tp", "4", "--fsdp", "1", "--resume", d["fsdp2xtp2_nano"],
        "--results-dir", str(tmp / "refused")])))
    # t2i at (1, 1, 2) -> (1, 2, 1)
    vq_model = vq.init_weights(vq.VQModel(T2I_VQ, encoder=True), seed=1)
    jobs2.append(("checkpointed", dict(
        cfg=T2I, batches=t2i_batches([1, 0, 1, 1]), ckpt_dir=d["t2i"],
        dp=1, fsdp=1, tp=2, save_at=SAVE_AT, resume_at=(1, 2, 1),
        vq_cfg=T2I_VQ, vq_weights=vq_model.state_dict(),
        weights=random_head(T2I), **dict(KW, remat="full"))))
    # the VQ-GAN: a one-process `.pt` -> dp 2
    lp = lpips_lib.init_weights(lpips_lib.LPIPS(), seed=9)
    vq_batches = [vq_images(seed=30 + i) for i in range(SAVE_AT + 1)]
    out["vq_one"] = _vq_one_process(vq_batches, d["pt_vq"], lp)
    jobs2.append(("vq_checkpointed", dict(
        cfg=VQ_CFG, loss_cfg=VQ_LOSS, batches=vq_batches[SAVE_AT:],
        ckpt_dir=d["pt_vq"], lpips_sd=lp.state_dict(), **VQ_KW)))
    # the c2i CLI: a one-process run's `.pt` resumed at tp 2
    train_c2i.main(cli[:1] + ["2"] + cli[2:] + ["--results-dir", d["cli"]])
    jobs2.append(("cli", dict(module="train_c2i", argv=cli + [
        "--tp", "2", "--fsdp", "1", "--resume",
        os.path.join(d["cli"], "checkpoints"),
        "--results-dir", str(tmp / "cli_tp2")])))
    out["four"] = launch("runs", 4, jobs4)
    out["two"] = launch("runs", 2, jobs2)
    out["cli_log"] = (tmp / "cli_tp2" / "log.txt").read_text()
    # (1, 1, 2) -> one process
    for name, cfg in CFGS.items():
        out["cfg"][name]["one_from_tp2"] = _resume_in_one_process(
            cfg, d[f"tp2_{name}"], c2i_batches(cfg)[SAVE_AT:],
            dict(KW, weights=random_head(cfg)))
    return out


def _resume_in_one_process(cfg, ckpt_dir, batches, kw):
    state, step = c2i.build_trainer(cfg, "cpu", **kw)
    with no_gather():
        got, state = checkpoint.restore_latest(ckpt_dir, state)
    assert got == SAVE_AT
    out = {"loaded": _full_state(state), "loss": [], "grad_norm": []}
    for b in batches:
        state, m = step(state, c2i.Batch(*(torch.from_numpy(x) for x in b)),
                        5)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    out.update(_full_state(state))
    return out


def _cases(runs, name):
    """(saved whole state, resumed run, unbroken run) of each resume of
    config `name`, by case id."""
    one = runs["cfg"][name]["one"]
    base = 5 * list(CFGS).index(name)
    tp2, fsdp2, from4, pt_tp2, pt_fsdp2 = (
        [r[base + i] for r in runs["two"]] for i in range(5))
    four = [r[list(CFGS).index(name)] for r in runs["four"]]
    return {
        "tp2->fsdp2": (tp2[0]["saved"], [r["resumed"] for r in tp2], tp2[0]),
        "fsdp2->tp2": (fsdp2[0]["saved"], [r["resumed"] for r in fsdp2],
                       fsdp2[0]),
        "fsdp2xtp2->dp2": (four[0]["saved"], from4, four[0]),
        "pt->tp2": (one["saved"], pt_tp2, one),
        "pt->fsdp2": (one["saved"], pt_fsdp2, one),
        "tp2->one": (tp2[0]["saved"], [runs["cfg"][name]["one_from_tp2"]],
                     tp2[0]),
    }


def assert_equal_state(got, want, label):
    assert got["step"] == want["step"] == SAVE_AT, label
    for key in ("params", "ema", "exp_avg", "exp_avg_sq"):
        assert got[key].keys() == want[key].keys(), (label, key)
        for n, t in want[key].items():
            assert torch.equal(got[key][n], t), f"{label} {key} {n}"


CASES = ["tp2->fsdp2", "fsdp2->tp2", "fsdp2xtp2->dp2", "pt->tp2",
         "pt->fsdp2", "tp2->one"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(CFGS))
def test_resume_at_another_layout(runs, name, case):
    """The state loaded at the new layout, made whole, is the saved one bit
    for bit; its next step is the unbroken run's within the bounds."""
    saved, resumed, unbroken = _cases(runs, name)[case]
    ref = {"loss": unbroken["loss"][SAVE_AT:],
           "grad_norm": unbroken["grad_norm"][SAVE_AT:],
           "params": unbroken["params"], "ema": unbroken["ema"]}
    for r, got in enumerate(resumed):
        assert_equal_state(got["loaded"], saved, f"{name} {case} rank {r}")
        assert got["step"] == SAVE_AT + 1
        assert_same_run(got, ref, label=f"{name} {case} rank {r}")


def test_t2i_resume_at_another_layout(runs):
    """t2i (the caption embedder whole on every rank, the frozen VQ in no
    checkpoint) saved at (1, 1, 2), resumed at (1, 2, 1)."""
    saving = [r[-3] for r in runs["two"]]
    for r, got in enumerate(r["resumed"] for r in saving):
        assert_equal_state(got["loaded"], saving[0]["saved"], f"t2i rank {r}")
        assert_same_run(got, {"loss": saving[0]["loss"][SAVE_AT:],
                              "grad_norm": saving[0]["grad_norm"][SAVE_AT:],
                              "params": saving[0]["params"],
                              "ema": saving[0]["ema"]}, label=f"t2i rank {r}")


def test_vq_gan_pt_resumes_at_dp2(runs):
    """A one-process VQ-GAN `.pt` at two data-parallel ranks: both models,
    both optimizers' moments, the EMA, the usage window and the step as
    saved; the next step's metrics, window and update as one process's."""
    one = runs["vq_one"]
    for r, got in enumerate(r[-2] for r in runs["two"]):
        loaded, saved = got["loaded"], one["saved"]
        assert loaded["step"] == saved["step"] == SAVE_AT
        assert torch.equal(loaded["window"], saved["window"])
        for key in ("vq", "disc", "ema", "vq_exp_avg", "vq_exp_avg_sq",
                    "disc_exp_avg", "disc_exp_avg_sq"):
            assert loaded[key].keys() == saved[key].keys(), key
            for n, t in saved[key].items():
                assert torch.equal(loaded[key][n], t), f"rank {r} {key} {n}"
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=3e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
        assert torch.equal(got["window"], one["window"])
        gmax = max(g.abs().max().item() for g in one["grads"].values())
        for n, p in one["params"].items():
            diff = (got["params"][n] - p).abs()
            big = one["grads"][n].abs() >= 10 * GRAD_TOL["vq"] * gmax
            if big.any():
                assert diff[big].max().item() <= 1e-2 * VQ_LR, n
            assert diff.max().item() <= 2 * VQ_LR * 1.001, n


@pytest.mark.parametrize("layout", ["tp2", "fsdp2", "fsdp2xtp2"])
@pytest.mark.parametrize("name", list(CFGS))
def test_dcp_bytes_within_pt(runs, name, layout):
    """Each piece is written once: the DCP directory holds at most 1.05 x
    the bytes of the same state's one-process `.pt`."""
    d = runs["dirs"]
    step = f"step_{SAVE_AT:08d}"
    dcp_bytes = _bytes(os.path.join(d[f"{layout}_{name}"], step))
    pt_bytes = _bytes(os.path.join(d[f"pt_{name}"], step + ".pt"))
    assert dcp_bytes <= 1.05 * pt_bytes, (dcp_bytes, pt_bytes)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["nano-tp2", "gqa-tp2",
                                                  "gqa-tp4"])
def test_tp_pieces_glue_to_whole_tp_state(runs, case):
    """Every rank's pieces put back at their offsets give exactly
    `whole_tp_state` of the shards (and the whole model they came from):
    wqkv's three blocks a rank, the row blocks of w1 / w3 / the head, the
    column blocks of wo / w2, the rest whole."""
    tp = (2, 2, 4)[case]
    ranks = [r[-2][case] for r in runs["four"]][:tp]
    whole = ranks[0]["whole"]
    weights = runs["weights"][("nano", "gqa", "gqa")[case]]
    for name, want in whole.items():
        shape, _ = ranks[0]["pieces"][name]
        glued = torch.full(shape, float("nan"))
        for r in ranks:
            local = r["local"][name]
            for p in r["pieces"][name][1]:
                glued[tuple(slice(o, o + n) for o, n in
                            zip(p.offsets, p.sizes))] = local[p.rows]
        assert torch.equal(glued, want), name
        assert torch.equal(glued, weights[name]), name
    wqkv = ranks[0]["pieces"]["layers.0.attention.wqkv.weight"][1]
    assert len(wqkv) == 3


def test_refused_tp_raises_before_any_load(runs):
    """GPT-nano's 2 heads at tp 4: the CLI raises JAX's `_check_tp`
    message before it reads the checkpoint; so do kv heads that do not
    divide by tp under GQA."""
    for r in runs["four"]:
        assert r[-1] == {"error": "2 heads do not divide by tp 4",
                         "loads": 0}
    with pytest.raises(ValueError, match="GQA under TP needs kv_heads % tp"):
        tp_decode.shard_tp_params(gpt.Transformer(replace(GQA, n_kv_head=2)),
                                  0, 4)


def test_cli_resumes_a_pt_at_tp2_and_logs_both_layouts(runs):
    """`cli/train_c2i.py --tp 2 --resume` on a one-process run's
    checkpoints takes the third step and names both layouts."""
    assert [r[-1]["step"] for r in runs["two"]] == [3, 3]
    assert ("saved at one process, loaded at (dp, fsdp, tp) = (1, 1, 2)"
            in runs["cli_log"])


def test_no_gather_refuses_every_gather():
    """The guard the saves and restores above ran under refuses the TP
    gathers and DTensor's, and puts them back after."""
    from llamagen_tpu_torch.parallel import collectives
    from torch.distributed.tensor import DTensor
    before = (collectives.gather_last, tp_decode.whole_tp_state,
              DTensor.full_tensor)
    with no_gather():
        for fn in (collectives.gather_last, tp_decode.gather_last,
                   tp_decode.whole_tp_state, checkpoint.whole_tp_state):
            with pytest.raises(AssertionError, match="gathered"):
                fn(torch.ones(2), None)
        with pytest.raises(AssertionError, match="gathered"):
            DTensor.full_tensor(None)
    assert (collectives.gather_last, tp_decode.whole_tp_state,
            DTensor.full_tensor) == before


def test_tp_pieces_map():
    """`tp_pieces` alone: wqkv at tp 2 under GQA (rank 1: 128 q rows, 64 k,
    64 v of [256 | 128 | 128]); wo's column block; a norm whole."""
    shape, pieces = tp_decode.tp_pieces("layers.1.attention.wqkv.weight",
                                        GQA, 2, 1, (256, 256))
    assert shape == (512, 256)
    assert [(p.rows, p.offsets, p.sizes) for p in pieces] == [
        (slice(0, 128), (128, 0), (128, 256)),
        (slice(128, 192), (256 + 64, 0), (64, 256)),
        (slice(192, 256), (256 + 128 + 64, 0), (64, 256))]
    shape, pieces = tp_decode.tp_pieces("layers.0.attention.wo.weight", GQA,
                                        4, 3, (256, 64))
    assert shape == (256, 256) and pieces[0].offsets == (0, 192)
    shape, pieces = tp_decode.tp_pieces("norm.weight", GQA, 4, 3, (256,))
    assert shape == (256,) and pieces[0].offsets == (0,)
