"""Port VQ-GAN training (llamagen_tpu_torch.train.vq, cli.train_vq)
against the JAX package on the CPU, and on the card (`-m cuda`; that
machine has no JAX, so run this file there with
`python -m pytest --noconftest -m cuda`).

The step comparison runs at narrow width: VQ-8 with ch 32 and a 64 x 4
codebook, f32, dropout 0, a full-width random LPIPS, EMA 0.9; PatchGAN
(hinge, l2) on 4 images of 32 px, StyleGAN (non-saturating, l1, the
adaptive weight) on 2 of 16 px (its blocks have 512 channels below 32 px).
The JAX step is `make_train_step_fn`, the weights are carried from JAX's
seeded init. Each of two steps starts both sides from the same state (the
second from JAX's state after the first, loaded into the port with its
Adam moments, EMA and usage window), because Adam turns a gradient at the
rounding level into an update of +-lr, so two free-running trains part by
lr at such elements after one step.

Tolerances (f32): every metric within 3e-4 relative + 1e-6 absolute (the
adaptive weight is a ratio of two gradient norms through ~45
convolutions). The clipped gradient of every parameter, as Adam sees it
(JAX's recovered from its Adam first moment): the VQ's within 5e-3 of its
largest, the discriminator's within 5e-2 of its largest. f32 rounding
puts a (leaky) ReLU input that lies within a few ulps of 0 on the other
slope in one framework now and then, and the gradients of batch means
are small against their terms where their terms cancel: the l2-normalised
quantizer input (1.7e-3 of the VQ's largest at quant_conv.bias) and
BatchNorm, which spreads one such element over its channel (1.6 % of the
discriminator's largest; against an f64 gradient of the same step, JAX's
f32 was exact there and the port's off by that one element).
`test_torch_discriminator.py` holds the discriminators' gradients of a
loss without that cancellation to 1e-5.
Each updated parameter is within 1 % of the learning rate where its
gradient is at least ten times its model's gradient bound, and within
Adam's bound of 2 lr elsewhere; the EMA within (1 - decay) times that; the
usage window, the ids and the step count equal. The loss functions equal
JAX's within 1e-6 relative, the usage window exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.cli import train_vq
from llamagen_tpu_torch.cli.common import load_vq
from llamagen_tpu_torch.config import vq_config
from llamagen_tpu_torch.models import discriminator as disc_lib
from llamagen_tpu_torch.models import lpips as lpips_lib
from llamagen_tpu_torch.models import vq
from llamagen_tpu_torch.train import vq as vqt
from llamagen_tpu_torch.utils import convert

try:
    import conftest  # noqa: F401  (JAX on the CPU)
    import jax
    import jax.numpy as jnp
    from llamagen_tpu.models import lpips as jlpips
    from llamagen_tpu.train import vq as jvqt
    from test_torch_gpt import jax_config
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jax = jnp = jlpips = jvqt = jax_config = None

NARROW = dataclasses.replace(vq_config("VQ-8"), ch=32, z_channels=64,
                             codebook_size=64, codebook_embed_dim=4)
LR, EMA = 1e-4, 0.9
# (discriminator, d loss, g loss, reconstruction, adaptive weight, batch,
# image size)
LOSSES = {"patchgan": ("patchgan", "hinge", "hinge", "l2", False, 4, 32),
          "stylegan": ("stylegan", "non-saturating", "non-saturating", "l1",
                       True, 2, 16)}
GRAD_TOL = {"vq": 5e-3, "disc": 5e-2}  # of the model's largest gradient


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the step on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def images(b, size, seed):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def loss_cfg(kind, disc_start, cls=vqt.VQLossConfig):
    d, dl, gl, rec, adaptive, _, size = LOSSES[kind]
    return cls(disc_start=disc_start, disc_type=d, disc_loss=dl,
               gen_adv_loss=gl, reconstruction_loss=rec,
               disc_adaptive_weight=adaptive, image_size=size)


# --- the loss functions and the usage window --------------------------------

LOSS_CASES = [("d", k) for k in sorted(vqt.D_LOSSES)] \
    + [("g", k) for k in sorted(vqt.G_LOSSES)] + [("rec", "l1"),
                                                  ("rec", "l2")]


@pytest.mark.parametrize("which,kind", LOSS_CASES)
def test_loss_functions_match_jax(which, kind):
    rng = np.random.RandomState(0)
    real, fake = (rng.randn(3, 5, 5, 1) * 2).astype(np.float32), \
        (rng.randn(3, 5, 5, 1) * 2).astype(np.float32)
    t = [torch.tensor(real), torch.tensor(fake)]
    j = [jnp.asarray(real), jnp.asarray(fake)]
    if which == "d":
        out, ref = vqt.D_LOSSES[kind](*t), jvqt.D_LOSSES[kind](*j)
    elif which == "g":
        out, ref = vqt.G_LOSSES[kind](t[1]), jvqt.G_LOSSES[kind](j[1])
    else:
        out, ref = vqt.rec_loss_fn(kind, *t), jvqt.rec_loss_fn(kind, *j)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("n", [1000, 65536, 70000])
def test_rolling_codebook_usage_matches_jax(n):
    """A batch of fewer, exactly as many and more ids than the window."""
    rng = np.random.RandomState(n)
    window = rng.randint(0, 512, vqt.USAGE_WINDOW).astype(np.int32)
    ids = rng.randint(0, 16384, (n // 16, 4, 4)).astype(np.int32)
    ids[: n // 32] = rng.randint(0, 64, (n // 32, 4, 4))
    jw, ju = jvqt.rolling_codebook_usage(jnp.asarray(window),
                                         jnp.asarray(ids), 16384)
    w, u = vqt.rolling_codebook_usage(torch.tensor(window).long(),
                                      torch.tensor(ids), 16384)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert w.shape == (vqt.USAGE_WINDOW,) and w.dtype == torch.long
    np.testing.assert_allclose(u.item(), float(ju), rtol=1e-6)
    np.testing.assert_allclose(
        vqt.codebook_usage(torch.tensor(ids), 16384).item(),
        float(jvqt.codebook_usage(jnp.asarray(ids), 16384)), rtol=1e-6)


# --- full steps against JAX's make_train_step_fn -----------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_dicts(kind):
    """JAX trees -> port state dicts (VQ; discriminator)."""
    to_disc = (convert.patchgan_state_dict_from_jax if kind == "patchgan"
               else convert.stylegan_state_dict_from_jax)
    return (lambda t: convert.vq_state_dict_from_jax(_np(t), NARROW),
            lambda t: to_disc(_np(t)))


def _adam(opt_state):
    """optax chain(clip, adam) state -> (mu, nu) trees."""
    return opt_state[1][0].mu, opt_state[1][0].nu


def _load_jax_state(state, jstate, kind):
    """The port's state := JAX's (parameters, Adam moments, EMA, window)."""
    to_vq, to_disc = _port_dicts(kind)
    with torch.no_grad():
        for module, opt, params, ost, conv in (
                (state.model, state.optimizer, jstate.params,
                 jstate.opt_state, to_vq),
                (state.disc, state.disc_optimizer, jstate.disc_params,
                 jstate.disc_opt_state, to_disc)):
            sd, (mu, nu) = conv(params), map(conv, _adam(ost))
            for name, p in module.named_parameters():
                p.copy_(sd[name])
                opt.opt.state[p]["exp_avg"].copy_(mu[name])
                opt.opt.state[p]["exp_avg_sq"].copy_(nu[name])
        ema = to_vq(jstate.ema_params)
        for name, e in state.ema.items():
            e.copy_(ema[name])
        state.usage_window.copy_(torch.tensor(np.asarray(
            jstate.usage_window)).long())


def _check_update(module, params, mu, mu_prev, conv, tol, label):
    """Gradients (JAX's from its Adam first moments: mu = 0.9 mu_prev +
    0.1 g) and parameters."""
    jp, g = conv(params), conv(mu)
    prev = conv(mu_prev)
    grads = {n: (g[n] - 0.9 * prev[n]) / 0.1 for n in g}
    names = [n for n, _ in module.named_parameters()]
    gmax = max(grads[n].abs().max().item() for n in names)
    for name, p in module.named_parameters():
        pg = torch.zeros_like(p) if p.grad is None else p.grad
        err = (pg - grads[name]).abs().max().item()
        assert err <= tol * max(gmax, 1e-30), \
            f"{label} grad {name}: {err:.3g} of max {gmax:.3g}"
        big = grads[name].abs() >= 10 * tol * gmax
        diff = (p.detach() - jp[name]).abs()
        assert diff[big].max().item() <= 1e-2 * LR if big.any() else True, \
            f"{label} {name}: {diff[big].max().item() / LR:.3g} lr"
        assert diff.max().item() <= 2 * LR * 1.001, f"{label} {name}"


@pytest.fixture(scope="module")
def jax_lpips():
    params = jax.jit(jlpips.init_params)(jax.random.PRNGKey(9))
    model = lpips_lib.LPIPS()
    model.load_state_dict(convert.lpips_state_dict_from_jax(_np(params)))
    return params, model


@pytest.mark.parametrize("kind", sorted(LOSSES))
def test_train_steps_match_jax(jax_lpips, kind, disc_start=1):
    """Two steps at disc_start 1: at the first the gate is shut (the
    discriminator's Adam steps on zero gradients, as optax does), at the
    second it opens (the adversarial term, the discriminator's update)."""
    lp_params, lp_model = jax_lpips
    jcfg = loss_cfg(kind, disc_start, jvqt.VQLossConfig)
    tx_g, tx_d = jvqt.make_vq_optimizer(LR), jvqt.make_vq_optimizer(LR)
    # one program for the init (as JAX's build_trainer), not one per op
    jstate = jax.jit(lambda key: jvqt.init_vq_train_state(
        key, jax_config(NARROW), jcfg, tx_g, tx_d, use_ema=True))(
            jax.random.PRNGKey(0))
    jstep = jax.jit(jvqt.make_train_step_fn(
        jax_config(NARROW), jcfg, tx_g, tx_d, use_lpips=True, ema_decay=EMA,
        compute_dtype=jnp.float32))
    to_vq, to_disc = _port_dicts(kind)
    model = vq.VQModel(NARROW, encoder=True)
    model.load_state_dict(to_vq(jstate.params))
    b, size = LOSSES[kind][-2:]
    disc = disc_lib.PatchGAN() if kind == "patchgan" \
        else disc_lib.StyleGAN(image_size=size)
    disc.load_state_dict(to_disc(jstate.disc_params))
    state = vqt.init_vq_train_state(
        model.train(), disc.train(), vqt.make_vq_optimizer(model, LR),
        vqt.make_vq_optimizer(disc, LR), use_ema=True)
    step = vqt.make_train_step(NARROW, loss_cfg(kind, disc_start),
                               lpips=lp_model, ema_decay=EMA)
    for i in range(2):
        if i:
            _load_jax_state(state, jstate, kind)
        prev_mu = (_adam(jstate.opt_state)[0], _adam(jstate.disc_opt_state)[0])
        x = images(b, size, seed=20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), lp_params)
        state, m = step(state, torch.tensor(x))
        for k, v in jm.items():
            np.testing.assert_allclose(m[k].item(), float(v), rtol=3e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        gate_open = i >= disc_start
        assert (float(jm["disc_loss"]) != 0) == gate_open
        if LOSSES[kind][4]:
            assert 0 < m["disc_adaptive_weight"].item() < 1e4
        assert state.step == int(jstate.step) == i + 1
        _check_update(state.model, jstate.params,
                      _adam(jstate.opt_state)[0], prev_mu[0], to_vq,
                      GRAD_TOL["vq"], f"step {i} vq")
        _check_update(state.disc, jstate.disc_params,
                      _adam(jstate.disc_opt_state)[0], prev_mu[1], to_disc,
                      GRAD_TOL["disc"], f"step {i} disc")
        ema = to_vq(jstate.ema_params)
        for name, e in state.ema.items():
            assert (e - ema[name]).abs().max() <= (1 - EMA) * 2 * LR + 1e-7
        np.testing.assert_array_equal(state.usage_window.numpy(),
                                      np.asarray(jstate.usage_window))


# --- the port alone ----------------------------------------------------------


def _tiny_trainer(remat, dropout_p, device="cpu", dtype=torch.float32,
                  disc_type="patchgan", seed=0):
    """A narrow trainer on `device` with the weights that the seeds give
    on the CPU (a CUDA generator draws other numbers)."""
    cfg = dataclasses.replace(NARROW, dropout_p=dropout_p)
    lp = lpips_lib.init_weights(lpips_lib.LPIPS(), seed=9).to(device)
    lcfg = vqt.VQLossConfig(disc_start=0, disc_type=disc_type,
                            disc_adaptive_weight=True, image_size=32)
    state, step = vqt.build_trainer(
        cfg, lcfg, torch.device(device), lr=LR, use_ema=True,
        ema_decay=EMA, seed=seed, lpips=lp, compute_dtype=dtype,
        remat=remat)
    if device != "cpu":
        state.model.load_state_dict(vq.init_weights(
            vq.VQModel(cfg, encoder=True), seed).state_dict())
        state.disc.load_state_dict(disc_lib.make_discriminator(
            disc_type, 32, seed=seed + 1).state_dict())
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                state.ema[name].copy_(p)
    return state, step


def test_remat_equals_no_remat_with_dropout():
    """Per-block checkpoints with dropout 0.1: each residual block reseeds
    its own generator, so the recomputed masks are the ones of the
    forward: two steps give bit-identical metrics and parameters. The
    masks are live (another dropout stream gives another loss)."""
    out = []
    for remat in (False, True):
        state, step = _tiny_trainer(remat, 0.1)
        metrics = [step(state, torch.tensor(images(2, 32, seed=30 + i)))[1]
                   for i in range(2)]
        out.append((metrics, dict(state.model.named_parameters())))
    (m0, p0), (m1, p1) = out
    for a, b in zip(m0, m1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for name, p in p0.items():
        assert torch.equal(p, p1[name]), name
    state, step = _tiny_trainer(False, 0.0)
    plain = step(state, torch.tensor(images(2, 32, seed=30)))[1]
    assert plain["rec_loss"].item() != m0[0]["rec_loss"].item()


def test_generator_backward_leaves_the_discriminator_alone():
    """Before disc_start the gated discriminator loss is 0: Adam steps on
    zero gradients (optax does), the discriminator does not move, and no
    generator gradient leaks into it."""
    cfg = vqt.VQLossConfig(disc_start=5, image_size=32)
    state, step = vqt.build_trainer(NARROW, cfg, torch.device("cpu"), lr=LR)
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    state, m = step(state, torch.tensor(images(2, 32, seed=40)))
    assert m["disc_loss"].item() == 0 and m["disc_grad_norm"].item() == 0
    assert all(p.grad is not None and torch.all(p.grad == 0)
               for p in state.disc.parameters())
    for k, v in state.disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.requires_grad for p in state.disc.parameters())


def test_train_vq_cli_on_cpu(tmp_path):
    """The CLI at a tiny size (VQ-8, 32 px, batch 2, 2 synthetic steps,
    bf16 + remat as its defaults), LPIPS from random state dicts in
    torchvision's and the reference's key layouts; the checkpoint loads
    as a whole tokenizer."""
    lp = lpips_lib.init_weights(lpips_lib.LPIPS(), seed=1).state_dict()
    vgg = {k.replace(f"net.slice{lpips_lib.slice_of(int(k.split('.')[2]))}.",
                     "features."): v
           for k, v in lp.items() if k.startswith("net.")}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save({k: v for k, v in lp.items() if k.startswith("lin")},
               tmp_path / "vgg.pth")
    args = ["--synthetic-steps", "2", "--vq-model", "VQ-8",
            "--codebook-size", "32", "--codebook-embed-dim", "4",
            "--image-size", "32", "--global-batch-size", "2",
            "--disc-start", "1", "--log-every", "1", "--ema",
            "--results-dir", str(tmp_path / "run"), "--device", "cpu"]
    state = train_vq.main(args + ["--vgg-weights", str(tmp_path / "vgg16.pth"),
                                  "--lpips-lins", str(tmp_path / "vgg.pth")])
    recs = [json.loads(line)
            for line in open(tmp_path / "run" / "metrics.jsonl")]
    recs = [r for r in recs if "gen_loss" in r]
    assert [r["step"] for r in recs] == [1, 2] and state.step == 2
    assert all(np.isfinite(r[k]) for r in recs for k in r if k != "step")
    assert recs[0]["perceptual_loss"] > 0 and recs[0]["disc_loss"] == 0
    assert recs[1]["disc_loss"] > 0
    ckpt = tmp_path / "run" / "checkpoints" / "step_00000002.pt"
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 2 and saved["usage_window"].shape == (65536,)
    assert {"discriminator", "optimizer_disc", "ema"} <= set(saved)
    tok = load_vq(str(ckpt), "VQ-8", 32, 4, torch.float32,
                  torch.device("cpu"), encoder=True)
    for name, p in state.model.state_dict().items():
        assert torch.equal(tok.state_dict()[name], p), name
    with pytest.raises(SystemExit):
        train_vq.main(args + ["--vgg-weights", str(tmp_path / "vgg16.pth")])
    with pytest.raises(ValueError, match="ranks"):  # one process: world 1
        train_vq.main(args + ["--dp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vq.main(args[:-2])


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_bf16_step_runs_on_the_card(cuda):
    state, step = _tiny_trainer(True, 0.1, device="cuda",
                                dtype=torch.bfloat16, disc_type="patchgan")
    x = torch.tensor(images(4, 32, seed=50), device=cuda)
    for _ in range(2):
        state, m = step(state, x)
    assert state.step == 2
    assert all(torch.isfinite(v).all() for v in m.values())
    assert m["disc_loss"].item() > 0 and m["perceptual_loss"].item() > 0


@pytest.mark.cuda
def test_f32_card_step_equals_cpu(cuda):
    """One f32 step (TF32 off) from the same weights on the card and the
    CPU, held as the JAX comparison is: metrics within 3e-4 relative +
    1e-6, gradients within GRAD_TOL of the model's largest, parameters
    within 1 % of lr where the gradient is at least ten times that, 2 lr
    elsewhere; the usage windows (the ids) equal."""
    out = {}
    for dev in ("cpu", "cuda"):
        state, step = _tiny_trainer(False, 0.0, device=dev, seed=3)
        x = torch.tensor(images(2, 32, seed=51), device=dev)
        state, m = step(state, x)
        out[dev] = (state, {k: v.item() for k, v in m.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k, v in cm.items():
        np.testing.assert_allclose(gm[k], v, rtol=3e-4, atol=1e-6,
                                   err_msg=k)
    for mod, tol in (("model", GRAD_TOL["vq"]), ("disc", GRAD_TOL["disc"])):
        ref = dict(getattr(cs, mod).named_parameters())
        gmax = max(p.grad.abs().max().item() for p in ref.values())
        for name, p in getattr(gs, mod).named_parameters():
            r = ref[name]
            assert (p.grad.cpu() - r.grad).abs().max() <= tol * gmax, name
            diff = (p.detach().cpu() - r.detach()).abs()
            big = r.grad.abs() >= 10 * tol * gmax
            if big.any():
                assert diff[big].max() <= 1e-2 * LR, name
            assert diff.max() <= 2 * LR * 1.001, name
    assert torch.equal(gs.usage_window.cpu(), cs.usage_window)
