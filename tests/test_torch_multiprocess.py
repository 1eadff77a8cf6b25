"""The port's training across ranks (`llamagen_tpu_torch/parallel/`, the
sharded trainers, DCP checkpoints, the CLIs under a process group) on the
CPU: two or four processes on gloo (`tests/torch_ranks.py` spawns them,
each on a free port, every join under a timeout), GPT-nano / narrow VQ-8
widths, f32.

Each sharded run is held against one process on the same global batch
(each rank feeds its stride of it) with `tests/test_torch_train.py`'s
tolerances: loss and grad_norm 1e-5 relative; parameters and EMA after
three AdamW steps within 1 % of the summed learning rate. The VQ-GAN step
uses `tests/test_torch_train_vq.py`'s bounds: metrics 3e-4 relative +
1e-6 absolute; gradients within 5e-3 (VQ) / 5e-2 (discriminator) of the
model's largest; parameters within 1 % of lr where the gradient is ten
times that share of the largest, 2 lr elsewhere; the usage window equal.
One two-rank FSDP run is held against JAX's sharded trainer on a (1, 2, 1)
mesh of two virtual CPU devices (its Pallas kernel in interpret mode).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.parallel.mesh import make_mesh as jmake_mesh
from llamagen_tpu.train import c2i as jc2i
from llamagen_tpu_torch.cli.common import load_gpt
from llamagen_tpu_torch.config import gpt_config, vq_config
from llamagen_tpu_torch.models import gpt, vq
from llamagen_tpu_torch.models import lpips as lpips_lib
from llamagen_tpu_torch.train import c2i, t2i
from llamagen_tpu_torch.train import vq as vqt
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config
from torch_ranks import launch, rank_env, free_port

NO_DROPOUT = dict(class_dropout_prob=0.0, token_dropout_p=0.0,
                  resid_dropout_p=0.0, ffn_dropout_p=0.0)
NANO = gpt_config("GPT-nano", block_size=64, **NO_DROPOUT)
# warmup 2 (the first update has lr 0), a clip that triggers, EMA 0.9
OPT = dict(lr=1e-3, weight_decay=0.05, max_grad_norm=0.05, warmup_steps=2,
           ema_decay=0.9, compute_dtype=torch.float32)
LR_SUM = 1e-3 * (0 + 0.5 + 1)  # the three updates' learning rates
BATCH, STEPS = 4, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def c2i_batches(cfg=NANO, n=STEPS, b=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.num_classes, (b,)),
             rng.randint(0, cfg.vocab_size, (b, cfg.block_size)))
            for _ in range(n)]


def random_head(cfg=NANO, seed=0):
    """The seeded init with a random head (the reference init zeroes it,
    which zeroes every other gradient of the first step)."""
    model = gpt.init_weights(gpt.Transformer(cfg), seed=seed)
    with torch.no_grad():
        model.output.weight.normal_(0, 0.02, generator=torch.Generator()
                                    .manual_seed(1))
    return {k: v.clone() for k, v in model.state_dict().items()}


def one_process(cfg, batches, make=c2i.Batch, vq_model=None, **kw):
    if vq_model is None:
        state, step = c2i.build_trainer(cfg, "cpu", **kw)
    else:
        state, step = t2i.build_trainer(cfg, vq_model, "cpu", **kw)
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        state, m = step(state, make(*(torch.from_numpy(x) for x in b)), 0)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    out["params"] = {n: p.detach() for n, p in state.model.named_parameters()}
    out["ema"] = state.ema
    return out


def assert_same_run(got, ref, lr_sum=LR_SUM, label=""):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                               err_msg=f"{label} loss")
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5,
                               err_msg=f"{label} grad_norm")
    for key in ("params", "ema"):
        for name, p in ref[key].items():
            err = (got[key][name] - p).abs().max().item()
            assert err <= 1e-2 * lr_sum, f"{label} {key} {name}: {err:.3g}"


# --- GPT: FSDP2, DDP and HSDP against one process ---------------------------


@pytest.mark.parametrize("dp,fsdp,world,remat", [
    (1, 2, 2, "full"), (2, 1, 2, False), (2, 2, 4, "full")],
    ids=["fsdp2", "dp2", "hsdp2x2"])
def test_sharded_steps_equal_one_process(dp, fsdp, world, remat):
    """Three steps (the warmup's lr-0 step, then clipped AdamW + EMA) on
    rank strides of the global batch equal one process's; DDP wraps the
    model, FSDP2 / HSDP shard it (remat "full" recomputes each block
    inside its FSDP2 unit)."""
    weights, batches = random_head(), c2i_batches()
    kw = dict(OPT, remat=remat, weights=weights)
    ref = one_process(NANO, batches, **kw)
    ranks = launch("gpt_steps", world, NANO, batches, dp=dp, fsdp=fsdp, **kw)
    for r, got in enumerate(ranks):
        assert got["wrapped"] == (fsdp == 1)  # DDP, else FSDP2
        assert_same_run(got, ref, label=f"rank {r}")


def test_two_rank_fsdp_equals_jax_sharded_trainer():
    """JAX's `c2i.build_trainer` on make_mesh(1, 2, 1) over two virtual
    CPU devices, and the port's at two FSDP2 ranks from JAX's init (its
    zero head too): three steps of the same global batches."""
    jcfg = jax_config(NANO)
    jmesh = jmake_mesh(1, 2, 1, devices=jax.devices()[:2])
    jopt = {k: v for k, v in OPT.items() if k != "compute_dtype"}
    jstate, jstep = jc2i.build_trainer(jcfg, jmesh, compute_dtype=jnp.float32,
                                       remat=False, seed=0, **jopt)
    weights = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), NANO)
    batches = c2i_batches(seed=3)
    ranks = launch("gpt_steps", 2, NANO, batches, dp=1, fsdp=2, remat=False,
                   weights=weights, **OPT)
    ref = {"loss": [], "grad_norm": []}
    for labels, tokens in batches:
        batch = jc2i.shard_batch(jc2i.Batch(jnp.asarray(labels),
                                            jnp.asarray(tokens)), jmesh)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        ref["loss"].append(float(jm["loss"]))
        ref["grad_norm"].append(float(jm["grad_norm"]))
    ref["params"] = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), NANO)
    ref["ema"] = gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.ema_params), NANO)
    assert ref["grad_norm"][0] > OPT["max_grad_norm"]  # the clip triggers
    for r, got in enumerate(ranks):
        assert_same_run(got, ref, label=f"rank {r} vs JAX")


# --- t2i: the valid weights over every rank ----------------------------------

T2I_T = 8
T2I_VQ = dataclasses.replace(vq_config("VQ-8"), ch=32, z_channels=64,
                             codebook_size=512)
T2I = gpt_config("GPT-nano", block_size=16, cls_token_num=T2I_T,
                 model_type="t2i", caption_dim=32,
                 vocab_size=T2I_VQ.codebook_size, **NO_DROPOUT)


def t2i_batches(valid, n=STEPS, seed=4):
    """32 px images, left-padded captions (pads 0..5) and `valid`."""
    rng = np.random.RandomState(seed)
    b = len(valid)
    out = []
    for _ in range(n):
        pads = rng.randint(0, T2I_T - 2, b)
        masks = (np.arange(T2I_T)[None] >= pads[:, None]).astype(np.int32)
        feats = rng.randn(b, T2I_T, T2I.caption_dim).astype(np.float32)
        out.append((rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
                    feats, masks, np.asarray(valid, np.float32)))
    return out


@pytest.mark.parametrize("dp,fsdp", [(1, 2), (2, 1)], ids=["fsdp2", "dp2"])
def test_t2i_bad_samples_on_one_rank(dp, fsdp):
    """Rank 1 holds the only bad sample (valid [1, 0, 1, 1]: rows 1 and 3
    are rank 1's). The loss and the update equal one process's global
    weighted mean, which the mean of the two ranks' own means is not.
    (Without class dropout the null caption takes no gradient: DDP is told
    to look for unused parameters.)"""
    vq_model = vq.init_weights(vq.VQModel(T2I_VQ, encoder=True), seed=1)
    weights = random_head(T2I)
    batches = t2i_batches([1, 0, 1, 1])
    kw = dict(OPT, remat="full", weights=weights)
    ref = one_process(T2I, batches, t2i.T2IBatch, vq_model, **kw)
    ranks = launch("gpt_steps", 2, T2I, batches, dp=dp, fsdp=fsdp,
                   vq_cfg=T2I_VQ, vq_weights=vq_model.state_dict(), **kw)
    for r, got in enumerate(ranks):
        assert_same_run(got, ref, label=f"rank {r}")
    # the naive mean of per-rank means: another number
    model = gpt.Transformer(T2I)
    model.load_state_dict(weights)
    b = t2i.T2IBatch(*(torch.from_numpy(x) for x in batches[0]))
    halves = [t2i.loss_fn(model, vq_model, t2i.T2IBatch(*(
        x[r::2] for x in b)), None, torch.float32, False).item()
        for r in (0, 1)]
    assert abs(np.mean(halves) / ref["loss"][0] - 1) > 1e-3


# --- VQ-GAN: data parallel ---------------------------------------------------

VQ_CFG = dataclasses.replace(vq_config("VQ-8"), ch=32, z_channels=64,
                             codebook_size=64, codebook_embed_dim=4,
                             entropy_loss_ratio=0.1)
VQ_LR = 1e-4
GRAD_TOL = {"vq": 5e-3, "disc": 5e-2}


def vq_images(b=4, size=32, seed=30):
    """Uneven rows: rank 1's (odd) rows are dim and shifted, so its own
    batch statistics are far from the global batch's."""
    x = np.random.RandomState(seed).uniform(-1, 1, (b, size, size, 3))
    x[1::2] = 0.2 * x[1::2] + 0.5
    return x.astype(np.float32)


def test_vq_gan_two_ranks_equal_one_process():
    """One step at two ranks (PatchGAN with BatchNorm, LPIPS, the adaptive
    weight, the entropy term at 0.1, disc_start 0) equals one process's on
    the same global batch: metrics, each parameter's gradient, the update
    and the usage window (the ids in the global row order). Then a second
    step's metrics."""
    lp = lpips_lib.init_weights(lpips_lib.LPIPS(), seed=9)
    lcfg = vqt.VQLossConfig(disc_start=0, disc_adaptive_weight=True,
                            image_size=32)
    kw = dict(lr=VQ_LR, use_ema=True, ema_decay=0.9)
    batches = [vq_images(seed=30), vq_images(seed=31)]
    state, step = vqt.build_trainer(VQ_CFG, lcfg, torch.device("cpu"),
                                    lpips=lp, **kw)
    ref = []
    for i, x in enumerate(batches):
        state, m = step(state, torch.from_numpy(x))
        ref.append({k: v.item() for k, v in m.items()})
        if i == 0:
            grads = {**{f"vq.{n}": p.grad.clone()
                        for n, p in state.model.named_parameters()},
                     **{f"disc.{n}": p.grad.clone()
                        for n, p in state.disc.named_parameters()}}
            params = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}
            window = state.usage_window.clone()
    assert ref[0]["entropy_loss"] != 0 and ref[0]["disc_loss"] > 0
    ranks = launch("vq_steps", 2, VQ_CFG, lcfg, batches[:1],
                   lpips_sd=lp.state_dict(), **kw)
    for r, got in enumerate(ranks):
        for k, v in ref[0].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=3e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
        for which in ("vq", "disc"):
            names = [n for n in grads if n.startswith(which + ".")]
            gmax = max(grads[n].abs().max().item() for n in names)
            for n in names:
                err = (got["grads"][n] - grads[n]).abs().max().item()
                assert err <= GRAD_TOL[which] * gmax, \
                    f"rank {r} grad {n}: {err:.3g} of {gmax:.3g}"
        gmax = max(grads[f"vq.{n}"].abs().max().item() for n in params)
        for n, p in params.items():
            diff = (got["params"][n] - p).abs()
            big = grads[f"vq.{n}"].abs() >= 10 * GRAD_TOL["vq"] * gmax
            if big.any():
                assert diff[big].max().item() <= 1e-2 * VQ_LR, n
            assert diff.max().item() <= 2 * VQ_LR * 1.001, n
        assert torch.equal(got["window"][0], window)
    # the ranks' own statistics would not do: the two halves' disc logits
    # differ from the global batch's
    disc = state.disc
    with torch.no_grad():
        whole = disc(torch.from_numpy(batches[1]))
        half = disc(torch.from_numpy(batches[1][1::2]))
    assert (whole[1::2] - half).abs().max() > 1e-2


# --- checkpoints -------------------------------------------------------------


def test_dcp_checkpoint_resumes_at_two_ranks_and_at_one(tmp_path):
    """Two FSDP2 ranks save a DCP checkpoint after two of three steps. A
    fresh two-rank run resumed from it takes the third step as the
    unbroken run did, bit for bit; so does one rank (a process group of
    one: the shards are read back whole), within the tolerances; the
    rank-0 whole-model export loads with `load_gpt`."""
    cfg = gpt_config("GPT-nano", block_size=64)  # dropout on
    batches = c2i_batches(cfg)
    kw = dict(OPT, remat="full", seed=3)
    ckpt = str(tmp_path / "ckpt")
    export = str(tmp_path / "model.pt")
    straight = launch("checkpointed", 2, cfg, batches, ckpt, fsdp=2,
                      save_at=2, export=export, **kw)
    assert os.path.isdir(os.path.join(ckpt, "step_00000002"))
    resumed = launch("checkpointed", 2, cfg, batches[2:], ckpt, fsdp=2,
                     resume=True, **kw)
    for a, b in zip(straight, resumed):
        assert b["step"] == a["step"] == 3 and b["opt_steps"] == [3.0]
        assert b["loss"] == a["loss"][2:]
        for key in ("params", "ema"):
            for name, p in a[key].items():
                assert torch.equal(b[key][name], p), (key, name)
    one = launch("checkpointed", 1, cfg, batches[2:], ckpt, fsdp=1,
                 resume=True, **kw)[0]
    assert one["step"] == 3
    # one rank draws rank 0's dropout stream of a 1-rank run: the same
    # batch, other masks; compare the whole state restored before it
    np.testing.assert_allclose(one["loss"][0], straight[0]["loss"][2],
                               rtol=0.05)
    model = load_gpt(export, "GPT-nano", 1024, 16, torch.float32,
                     torch.device("cpu"))
    for name, p in model.state_dict().items():
        assert torch.equal(p, straight[0]["params"][name]), name


def test_dcp_checkpoint_restores_in_one_process(tmp_path):
    """A two-rank DCP checkpoint loads into a one-process trainer (no
    process group): its parameters, EMA, Adam state and step equal the
    two ranks' at the save. A later save cut before DCP wrote its
    `.metadata` is passed over."""
    cfg = NANO
    batches = c2i_batches(n=2)
    kw = dict(OPT, weights=random_head())
    ckpt = str(tmp_path / "ckpt")
    saved = launch("checkpointed", 2, cfg, batches, ckpt, fsdp=2, save_at=2,
                   **kw)[0]
    cut = os.path.join(ckpt, "step_00000009")
    shutil.copytree(os.path.join(ckpt, "step_00000002"), cut)
    os.remove(os.path.join(cut, ".metadata"))
    state, _ = c2i.build_trainer(cfg, "cpu", **kw)
    from llamagen_tpu_torch.utils import checkpoint
    step, state = checkpoint.restore_latest(ckpt, state)
    assert step == 2 and state.step == 2
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), saved["params"][name]), name
        assert torch.equal(state.ema[name], saved["ema"][name]), name
    assert sorted({float(s["step"]) for s in
                   state.optimizer.opt.state.values()}) == [2.0]


# --- dropout streams ---------------------------------------------------------


def test_dropout_streams_differ_between_ranks_and_repeat_under_remat():
    """Every rank given the same rows: each draws from its own stream
    (seed * world + rank), so their losses differ; each rank's loss and
    the updated parameters are the same with remat "full" as without."""
    cfg = gpt_config("GPT-nano", block_size=64, drop_path_rate=0.1)
    labels, tokens = c2i_batches(cfg, n=1)[0]
    r0, r1 = launch("dropout_draws", 2, cfg, labels, tokens,
                    weights=random_head(cfg))
    assert r0[False]["seed"] != r1[False]["seed"]
    assert r0[False]["loss"] != r1[False]["loss"]
    for r in (r0, r1):
        assert r[False]["loss"] == r["full"]["loss"]
        for name, p in r[False]["params"].items():
            assert torch.equal(p, r["full"]["params"][name]), name
            assert torch.equal(p, r1[False]["params"][name]), name


# --- the CLIs at two ranks ---------------------------------------------------

CLI_RUNS = {
    "train_c2i": ["--gpt-model", "GPT-nano", "--image-size", "128",
                  "--global-batch-size", "4", "--synthetic-steps", "2",
                  "--log-every", "1"],
    "train_t2i": ["--gpt-model", "GPT-nano", "--image-size", "64",
                  "--global-batch-size", "4", "--synthetic-steps", "2",
                  "--log-every", "1"],
    "train_vq": ["--vq-model", "VQ-8", "--codebook-size", "32",
                 "--codebook-embed-dim", "4", "--image-size", "32",
                 "--global-batch-size", "4", "--synthetic-steps", "2",
                 "--disc-start", "1", "--log-every", "1",
                 "--mixed-precision", "none"],
}
def test_vq_image_stream_skips_a_bad_batch_on_every_rank(tmp_path):
    """`train_vq.image_batches` on a folder of one-colour images and an
    unreadable one: a global batch that draws the unreadable image is
    skipped by both ranks, also where only one rank's stride holds it, so
    the two ranks' rows stay the strides of one process's batches."""
    pytest.importorskip("PIL")
    from PIL import Image
    from llamagen_tpu_torch.cli.train_vq import image_batches
    colours = [30 * (i + 1) for i in range(6)]
    for i, c in enumerate(colours):
        Image.new("RGB", (12, 10), (c, c, c)).save(tmp_path / f"img{i}.png")
    (tmp_path / "bad.png").write_bytes(b"not an image")  # sorts first
    pick = np.random.RandomState(0)
    draws = [pick.choice(7, size=4) for _ in range(6)]
    # draw 0 puts the bad image in rank 0's stride only; 3 and 4 skip too
    assert [0 in d for d in draws] == [True, False, False, True, True,
                                       False]
    want = [[colours[i - 1] for i in d] for d in draws if 0 not in d][:3]

    def colour(batch):
        return [int(round((x + 1) * 127.5)) for x in batch.mean((1, 2, 3))]

    one = image_batches(str(tmp_path), 8, 4, seed=0)
    assert [colour(next(one)) for _ in range(3)] == want
    ranks = launch("image_stream", 2, str(tmp_path), 8, 4, 3)
    got = [colour(np.stack([a, b], 1).reshape(4, 8, 8, 3))
           for a, b in zip(*ranks)]
    assert got == want


# FSDP2 for c2i, DDP for t2i and the VQ-GAN
CLI_MESH = {"train_c2i": ["--fsdp", "2"], "train_t2i": ["--dp", "2"],
            "train_vq": ["--dp", "2"]}


@pytest.mark.parametrize("module", sorted(CLI_RUNS))
def test_cli_at_two_ranks(module, tmp_path):
    """Each training CLI at two gloo ranks with --synthetic-steps: both
    ranks take every step, only rank 0 writes metrics.jsonl, the group is
    torn down, the final checkpoint is a DCP directory beside the
    whole-model export, and the first step's loss is one process's on the
    same global batch (later ones part: c2i and t2i keep their dropout on,
    drawn per rank, and Adam turns the VQ-GAN's rounding-level gradient
    differences into +-lr)."""
    argv = CLI_RUNS[module] + ["--device", "cpu"]
    ranks = launch("cli", 2, module, argv + CLI_MESH[module] + [
        "--results-dir", str(tmp_path / "two")])
    assert [r["step"] for r in ranks] == [2, 2]
    assert not any(r["group_left"] for r in ranks)
    ckpts = tmp_path / "two" / "checkpoints"
    assert (ckpts / "step_00000002").is_dir()
    assert (ckpts / "step_00000002_model.pt").is_file()
    import importlib
    main = importlib.import_module(f"llamagen_tpu_torch.cli.{module}").main
    main(argv + ["--results-dir", str(tmp_path / "one")])
    key = "gen_loss" if module == "train_vq" else "loss"
    losses = {}
    for run in ("one", "two"):
        recs = [json.loads(line)
                for line in open(tmp_path / run / "metrics.jsonl")]
        losses[run] = [r[key] for r in recs if key in r]
    assert len(losses["two"]) == 2
    # c2i / t2i: the zero head makes the first loss ln V under any dropout
    np.testing.assert_allclose(losses["two"][0], losses["one"][0],
                               rtol=3e-4 if module == "train_vq" else 1e-5)


def test_torchrun_launches_the_c2i_cli(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    llamagen_tpu_torch.cli.train_c2i ... --device cpu`: the real launcher
    on gloo, FSDP2 over both ranks."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "llamagen_tpu_torch.cli.train_c2i",
           *CLI_RUNS["train_c2i"], "--fsdp", "2", "--device", "cpu",
           "--results-dir", str(tmp_path)]
    env = {k: v for k, v in os.environ.items()
           if k not in rank_env(0, 1, 0)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=conftest.REPO_ROOT)
    res = subprocess.run(cmd, cwd=conftest.REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert (tmp_path / "checkpoints" / "step_00000002").is_dir()
