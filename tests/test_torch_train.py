"""Port training (llamagen_tpu_torch.models.gpt.forward_train,
train/{train_state,c2i}.py, utils/checkpoint.py, cli/train_c2i.py) against
the JAX package on the CPU, at GPT-nano size with block_size 64. JAX runs
its Pallas training-attention kernel in interpret mode, as its own tests do.

Tolerances (f32): logits 2e-4 (the PARITY.md GPT logits tolerance), loss
1e-5; gradients and optimizer states within 1e-5 of each tensor's largest
magnitude (sums taken in another order through two layers); parameters
and EMA after three AdamW steps within 1 % of the summed learning rate.
"""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import gpt as jgpt
from llamagen_tpu.train import c2i as jc2i
from llamagen_tpu.train.train_state import init_train_state as jinit_state
from llamagen_tpu.train.train_state import make_optimizer
from llamagen_tpu_torch.cli import train_c2i
from llamagen_tpu_torch.config import GPTConfig, gpt_config
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import train_attention
from llamagen_tpu_torch.train import c2i
from llamagen_tpu_torch.train.train_state import (Optimizer, decay_mask,
                                                  init_train_state)
from llamagen_tpu_torch.utils import checkpoint
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

NO_DROPOUT = dict(block_size=64, class_dropout_prob=0.0, token_dropout_p=0.0,
                  resid_dropout_p=0.0, ffn_dropout_p=0.0)
NANO = gpt_config("GPT-nano", **NO_DROPOUT)
GQA = GPTConfig(dim=256, n_layer=2, n_head=4, n_kv_head=2, **NO_DROPOUT)


def _batch(cfg, seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.num_classes, size=(b,)),
            rng.randint(0, cfg.vocab_size, size=(b, cfg.block_size)))


def _close(a, b, rel, name=""):
    """max |a - b| <= rel * max |b| (the tolerance scales with the
    tensor)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    err = np.abs(a - b).max()
    assert err <= rel * max(np.abs(b).max(), 1e-30), \
        f"{name}: max err {err:.3g}, max |ref| {np.abs(b).max():.3g}"


def _jax_grads_as_port(grads, cfg):
    return gpt_state_dict_from_jax(jax.tree.map(np.asarray, grads), cfg)


@pytest.mark.parametrize("cfg,remat", [(NANO, False), (NANO, "full"),
                                       (GQA, False)],
                         ids=["nano", "nano-remat", "gqa"])
def test_forward_train_loss_and_grads_match_jax(cfg, remat):
    params, model = make_pair(cfg)
    jcfg = jax_config(cfg)
    labels, tokens = _batch(cfg)
    jbatch = jc2i.Batch(labels=jnp.asarray(labels), tokens=jnp.asarray(tokens))
    jloss, jgrads = jax.value_and_grad(jc2i.loss_fn)(
        params, jcfg, jbatch, jax.random.PRNGKey(0), jnp.float32, False)
    jlogits, _ = jgpt.forward_train(params, jcfg, jbatch.labels,
                                    jbatch.tokens[:, :-1], train=False,
                                    compute_dtype=jnp.float32)

    logits, loss = gpt.forward_train(
        model, torch.tensor(labels), torch.tensor(tokens[:, :-1]),
        targets=torch.tensor(tokens), compute_dtype=torch.float32,
        remat=remat)
    loss.backward()
    assert logits.shape == (2, cfg.block_size, cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = _jax_grads_as_port(jgrads, cfg)
    for name, p in model.named_parameters():
        _close(p.grad, jg[name], 1e-5, name)


def test_three_train_steps_match_optax():
    """Warmup 2 (the first update has lr 0), a clip that triggers, AdamW
    with the decay mask, EMA 0.9: params, EMA and grad_norm after each of
    three steps."""
    cfg = NANO
    params, model = make_pair(cfg)
    kw = dict(lr=1e-3, weight_decay=0.05, max_grad_norm=0.05,
              warmup_steps=2)
    tx = make_optimizer(**kw)
    jstate = jinit_state(params, tx, use_ema=True)
    jstep = jc2i.make_train_step(jax_config(cfg), tx, ema_decay=0.9,
                                 compute_dtype=jnp.float32, remat=False)
    state = init_train_state(model, Optimizer(model, **kw), use_ema=True)
    step = c2i.make_train_step(ema_decay=0.9, compute_dtype=torch.float32,
                               remat=False)
    for i in range(3):
        labels, tokens = _batch(cfg, seed=i)
        jstate, jm = jstep(jstate, jc2i.Batch(jnp.asarray(labels),
                                              jnp.asarray(tokens)),
                           jax.random.PRNGKey(0))
        state, m = step(state, c2i.Batch(torch.tensor(labels),
                                         torch.tensor(tokens)), 0)
        assert float(jm["grad_norm"]) > 0.05  # the clip triggers
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    jp = _jax_grads_as_port(jstate.params, cfg)
    je = _jax_grads_as_port(jstate.ema_params, cfg)
    # Each update is at most ~lr per element; it agrees within 1 % of lr.
    # (Where a gradient element is near Adam's eps, 1e-8, the update
    # lr * g / (|g| + eps) turns the gradients' f32 noise into ~1 % of lr.)
    atol = 1e-2 * sum(Optimizer(model, **kw).lr_at(i) for i in range(3))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), je[name].numpy(),
                                   rtol=0, atol=atol, err_msg=f"ema {name}")


def test_decay_mask_matches_jax_names():
    model = gpt.Transformer(NANO)
    no_decay = sorted(n for n, _ in model.named_parameters()
                      if not decay_mask(n))
    assert no_decay == ["layers.0.attention_norm.weight",
                        "layers.0.ffn_norm.weight",
                        "layers.1.attention_norm.weight",
                        "layers.1.ffn_norm.weight", "norm.weight"]


@pytest.mark.parametrize("attn_dropout", [0.0, 0.1],
                         ids=["kernel-path", "attn-dropout"])
def test_remat_redraws_the_same_dropout_masks(attn_dropout):
    """With every dropout on, remat="full" and remat=False give identical
    loss and gradients from one seed: each recomputed layer reseeds its
    own generator (torch.utils.checkpoint restores only the default RNG
    states)."""
    cfg = gpt_config("GPT-nano", block_size=64, drop_path_rate=0.2,
                     attn_dropout_p=attn_dropout)
    labels, tokens = _batch(cfg, b=4)
    runs = []
    for remat in (False, "full"):
        model = gpt.init_weights(gpt.Transformer(cfg), seed=0)
        with torch.no_grad():
            model.output.weight.normal_(0, 0.02,
                                        generator=torch.Generator()
                                        .manual_seed(1))
        loss = c2i.loss_fn(model, c2i.Batch(torch.tensor(labels),
                                            torch.tensor(tokens)),
                           c2i.step_generator(0, 5), torch.float32, remat)
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
    # and the dropout is real: another seed gives another loss
    model = gpt.init_weights(gpt.Transformer(cfg), seed=0)
    with torch.no_grad():
        model.output.weight.normal_(0, 0.02,
                                    generator=torch.Generator().manual_seed(1))
    other = c2i.loss_fn(model, c2i.Batch(torch.tensor(labels),
                                         torch.tensor(tokens)),
                        c2i.step_generator(0, 6), torch.float32, False)
    assert other.item() != runs[0][0]


def test_dropout_drop_path_and_class_dropout_rates():
    """Keep rates within 5 binomial sigmas, kept values scaled by
    1 / (1 - p), drop-path all-or-nothing per sample."""
    g = torch.Generator().manual_seed(0)
    n = 200_000
    x = gpt._dropout(torch.ones(n), 0.1, g)
    kept = x != 0
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / n) ** 0.5
    assert torch.equal(x[kept], torch.full_like(x[kept], 1 / 0.9))

    rows = 20_000
    y = gpt._drop_path(torch.ones(rows, 3, 4), 0.2, g)
    per_row = (y != 0).float().mean(dim=(1, 2))
    assert torch.equal(per_row, per_row.round())  # whole rows only
    assert abs(per_row.mean().item() - 0.8) < 5 * (0.16 / rows) ** 0.5
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.8))

    cfg = gpt_config("GPT-nano", block_size=64, class_dropout_prob=0.3)
    model = gpt.Transformer(cfg)
    with torch.no_grad():
        model.cls_embedding.embedding_table.weight[:, 0] = torch.arange(
            cfg.num_classes + 1, dtype=torch.float32)
    labels = torch.randint(0, cfg.num_classes, (rows,), generator=g)
    emb = model.embed_condition(labels, g)
    null = emb[:, 0, 0] == cfg.num_classes
    assert emb.shape == (rows, 1, cfg.dim)
    assert abs(null.float().mean().item() - 0.3) < 5 * (0.21 / rows) ** 0.5
    assert torch.equal(emb[~null, 0, 0], labels[~null].float())
    assert torch.equal(model.embed_condition(labels)[:, 0, 0],
                       labels.float())  # no generator: no dropout


def test_checkpoint_resume_equals_straight_steps(tmp_path):
    """2 steps, save, resume into a fresh trainer, 1 step == 3 straight
    steps, bit for bit (dropout on: each step's masks depend on (seed,
    step) only)."""
    cfg = gpt_config("GPT-nano", block_size=64)
    kw = dict(warmup_steps=1, compute_dtype=torch.float32, seed=3)
    batches = [c2i.Batch(*(torch.tensor(a) for a in _batch(cfg, seed=i)))
               for i in range(3)]
    straight, step_fn = c2i.build_trainer(cfg, "cpu", **kw)
    for b in batches:
        step_fn(straight, b, 7)

    first, step_fn = c2i.build_trainer(cfg, "cpu", **kw)
    for b in batches[:2]:
        step_fn(first, b, 7)
    path = checkpoint.save_step(str(tmp_path), first.step, first)
    assert os.path.basename(path) == "step_00000002.pt"
    assert checkpoint.latest_step(str(tmp_path)) == 2
    resumed, step_fn = c2i.build_trainer(cfg, "cpu", **kw)
    step, resumed = checkpoint.restore_latest(str(tmp_path), resumed)
    assert step == 2 and resumed.step == 2
    step_fn(resumed, batches[2], 7)
    for (name, p), q in zip(straight.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(straight.ema[name], resumed.ema[name]), name
    assert checkpoint.restore_latest(str(tmp_path / "none"), resumed) == \
        (None, None)


def test_train_c2i_cli_synthetic(tmp_path):
    """The JAX CLI test (tests/test_cli_smoke.py) on the port, on the CPU,
    then a resume for one more step."""
    before = train_attention.train_attention_fwd.launches
    common = ["--gpt-model", "GPT-nano", "--image-size", "128",
              "--downsample-size", "16", "--global-batch-size", "8",
              "--log-every", "1", "--ckpt-every", "1000", "--device", "cpu",
              "--results-dir", str(tmp_path)]
    state = train_c2i.main(["--synthetic-steps", "3"] + common)
    assert state.step == 3
    assert os.path.exists(tmp_path / "checkpoints" / "step_00000003.pt")
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    steps = [r["step"] for r in recs if "loss" in r]
    assert steps == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs if "loss" in r)
    # init_weights zeroes the head: every logit is 0 at the first step
    assert abs(recs[1]["loss"] - np.log(16384)) < 1e-3
    # CPU tensors take the plain attention: no kernel launch
    assert train_attention.train_attention_fwd.launches == before

    state = train_c2i.main(["--synthetic-steps", "4", "--resume",
                            str(tmp_path / "checkpoints")] + common)
    assert state.step == 4
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]


def test_train_c2i_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--synthetic-steps", "1", "--gpt-model", "GPT-nano",
            "--device", "cpu", "--results-dir", str(tmp_path)]
    # without torchrun the world is one process, so a larger mesh (a TP
    # one too) is refused
    for extra in (["--tp", "2"], ["--dp", "2"], ["--fsdp", "4"],
                  ["--dp", "2", "--fsdp", "2"]):
        with pytest.raises(ValueError, match="ranks"):
            train_c2i.main(base + extra)
    with pytest.raises(ValueError, match="remat"):
        gpt.forward_train(gpt.Transformer(NANO), torch.zeros(1, dtype=int),
                          torch.zeros(1, 63, dtype=int), remat="attn")


def test_save_attn_remat_equals_full_on_cpu():
    """On CPU tensors the attention is the plain version, which the
    save_attn policy does not name: it recomputes everything, as "full"
    does, and gives the same loss and gradients (the card's test counts
    the kernel launches it saves)."""
    cfg = gpt_config("GPT-nano", block_size=64)
    labels, tokens = _batch(cfg)
    runs = []
    for remat in ("full", "save_attn"):
        model = gpt.init_weights(gpt.Transformer(cfg), seed=0)
        with torch.no_grad():
            model.output.weight.normal_(0, 0.02, generator=torch.Generator()
                                        .manual_seed(1))
        loss = c2i.loss_fn(model, c2i.Batch(torch.tensor(labels),
                                            torch.tensor(tokens)),
                           c2i.step_generator(0, 1), torch.float32, remat)
        loss.backward()
        runs.append((loss.item(), [p.grad for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
