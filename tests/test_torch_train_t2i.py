"""Port t2i training (llamagen_tpu_torch.train.t2i, data.t2i,
cli.train_t2i) against the JAX package on the CPU: GPT-nano width with the
released 120 caption rows, a narrow VQ-8 (ch 32) tokenizing 32 px images
online into 4 x 4 codes, f32, dropout off. JAX runs its Pallas
training-attention kernel in interpret mode, as its own tests do.

Tolerances (f32, as tests/test_torch_train.py): loss 1e-5 relative;
gradients within 1e-5 of each tensor's largest magnitude; parameters and
EMA after three AdamW steps within 1 % of the summed learning rate. Token ids,
dataset batches and the frozen VQ weights: equal."""

import json

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.data.t2i import T2IDataset as JT2IDataset
from llamagen_tpu.train import t2i as jt2i
from llamagen_tpu.train.train_state import init_train_state as jinit_state
from llamagen_tpu.train.train_state import make_optimizer
from llamagen_tpu_torch.cli import train_t2i
from llamagen_tpu_torch.config import gpt_config
from llamagen_tpu_torch.data.t2i import T2IDataset
from llamagen_tpu_torch.train import t2i
from llamagen_tpu_torch.train.train_state import Optimizer, init_train_state
from llamagen_tpu_torch.utils.convert import gpt_state_dict_from_jax
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from test_torch_t2i import T, make_t2i_pair
from test_torch_train import _close
from test_torch_vq_encode import NARROW, images, make_vq_pair

VQ8 = NARROW["VQ-8"]  # 32 px -> 4 x 4 codes of a 512-entry codebook
CFG = gpt_config("GPT-nano", block_size=16, cls_token_num=T,
                 model_type="t2i", caption_dim=48,
                 vocab_size=VQ8.codebook_size, class_dropout_prob=0.0,
                 token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0)


@pytest.fixture(scope="module")
def pairs():
    gpt_params, model = make_t2i_pair(CFG)
    vq_params, vq_model = make_vq_pair(VQ8, seed=1)
    return gpt_params, model.train(), vq_params, vq_model


def t2i_batch(pads, valid, seed=2):
    """Images, left-padded caption features (random values on the pad rows
    too: the mask must zero them), ragged masks and valid flags."""
    rng = np.random.RandomState(seed)
    b = len(pads)
    feats = rng.randn(b, T, CFG.caption_dim).astype(np.float32)
    masks = (np.arange(T)[None, :] >= np.asarray(pads)[:, None]) \
        .astype(np.int32)
    return (images(b, 32, seed), feats, masks,
            np.asarray(valid, np.float32))


def _jax_batch(arrs):
    return jt2i.T2IBatch(*(jnp.asarray(a) for a in arrs))


def _port_batch(arrs):
    return t2i.T2IBatch(*(torch.tensor(a) for a in arrs))


CASES = {"full": ([0, 0], [1, 1]),
         "ragged": ([0, 60, 119], [1, 1, 1]),
         "valid-zero": ([5, 100, 119, 0], [1, 0, 1, 0])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_t2i_loss_and_grads_match_jax(pairs, case):
    gpt_params, model, vq_params, vq_model = pairs
    arrs = t2i_batch(*CASES[case])
    jloss, jgrads = jax.value_and_grad(jt2i.t2i_loss_fn)(
        gpt_params, vq_params, jax_config(CFG), jax_config(VQ8),
        _jax_batch(arrs), None, jnp.float32, False)
    model.zero_grad()
    loss = t2i.loss_fn(model, vq_model, _port_batch(arrs), None,
                       torch.float32, False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jg = gpt_state_dict_from_jax(jax.tree.map(np.asarray, jgrads), CFG)
    for name, p in model.named_parameters():
        # uncond_embedding is unused with CFG dropout off: JAX's gradient
        # is zero, autograd gives none
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, jg[name], 1e-5, name)
    assert all(p.grad is None for p in vq_model.parameters())


def test_train_steps_match_jax_and_leave_the_vq(pairs):
    """Three steps as tests/test_torch_train.py's c2i case (warmup 2, so
    the first update has lr 0; a clip that triggers; AdamW with the decay
    mask; EMA 0.9), each on another batch with `valid` zeros and ragged
    masks."""
    gpt_params, _, vq_params, vq_model = pairs
    _, model = make_t2i_pair(CFG)  # fresh weights: the steps update them
    kw = dict(lr=1e-3, weight_decay=0.05, max_grad_norm=0.05,
              warmup_steps=2)
    tx = make_optimizer(**kw)
    jstate = jinit_state(gpt_params, tx, use_ema=True)
    jstep = jt2i.make_t2i_train_step(jax_config(CFG), jax_config(VQ8), tx,
                                     vq_params, ema_decay=0.9,
                                     compute_dtype=jnp.float32, remat=False)
    before = {k: v.clone() for k, v in vq_model.state_dict().items()}
    state = init_train_state(model.train(), Optimizer(model, **kw),
                             use_ema=True)
    step = t2i.make_train_step(vq_model, ema_decay=0.9,
                               compute_dtype=torch.float32, remat=False)
    for i in range(3):
        arrs = t2i_batch(*CASES["valid-zero"], seed=10 + i)
        jstate, jm = jstep(jstate, _jax_batch(arrs), jax.random.PRNGKey(0))
        state, m = step(state, _port_batch(arrs), 0)
        assert float(jm["grad_norm"]) > 0.05  # the clip triggers
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    jp = gpt_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), CFG)
    je = gpt_state_dict_from_jax(jax.tree.map(np.asarray, jstate.ema_params),
                                 CFG)
    atol = 1e-2 * sum(Optimizer(model, **kw).lr_at(i) for i in range(3))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(state.ema[name].numpy(), je[name].numpy(),
                                   rtol=0, atol=atol, err_msg=f"ema {name}")
    # the frozen tokenizer: no gradient, no update, in no optimizer or EMA
    for k, v in vq_model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in vq_model.parameters())
    assert not {id(p) for p in vq_model.parameters()} & {
        id(p) for g in state.optimizer.opt.param_groups for p in g["params"]}
    assert set(state.ema) == set(dict(model.named_parameters()))


def test_step_refuses_a_vq_it_cannot_run(pairs):
    vq_model = pairs[3]
    with pytest.raises(ValueError, match="compute dtype"):
        t2i.make_train_step(vq_model, compute_dtype=torch.bfloat16)
    from llamagen_tpu_torch.models.vq import VQModel
    with pytest.raises(ValueError, match="decode half"):
        t2i.make_train_step(VQModel(VQ8), compute_dtype=torch.float32)


@pytest.mark.parametrize("n_layer", [16, 36])
def test_left_padded_gradients_at_depth(n_layer):
    """Left-pad rows stay exactly 0 through every layer; their activation
    gradient grows by RMSNorm's 1 / sqrt(eps) at each norm. JAX's f32
    gradients overflow to NaN by 36 layers (a fault of the reference); the
    port stops the gradient at those rows, which adds exactly 0 to every
    parameter gradient: at 16 layers (JAX still finite, the pad rows'
    gradients ~1e20) its gradients equal JAX's within 1e-5 of each
    tensor's largest magnitude; at 36 they are finite, the loss JAX's."""
    from llamagen_tpu.models import gpt as jgpt
    from llamagen_tpu_torch.config import replace
    from llamagen_tpu_torch.models import gpt

    cfg = replace(CFG, n_layer=n_layer)
    params, model = make_t2i_pair(cfg)
    rng = np.random.RandomState(3)
    params["output"] = jnp.asarray(  # the scale of the reference init
        rng.randn(cfg.dim, cfg.vocab_size).astype(np.float32) * 0.02)
    model.output.weight.data = torch.tensor(np.asarray(params["output"]).T)
    _, feats, masks, _ = t2i_batch([60, 119], [1, 1])
    caps = feats * masks[..., None]
    tok = rng.randint(0, cfg.vocab_size, (2, cfg.block_size))

    def jloss(p):
        return jgpt.forward_train(p, jax_config(cfg), jnp.asarray(caps),
                                  jnp.asarray(tok[:, :-1]),
                                  targets=jnp.asarray(tok),
                                  compute_dtype=jnp.float32)[1]

    jl, jg = jax.value_and_grad(jloss)(params)
    _, loss = gpt.forward_train(model, torch.tensor(caps),
                                torch.tensor(tok[:, :-1]),
                                targets=torch.tensor(tok),
                                compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = gpt_state_dict_from_jax(jax.tree.map(np.asarray, jg), cfg)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values())
    if n_layer == 36:
        assert not all(np.isfinite(g.numpy()).all() for g in jg.values())
    else:
        for name, g in grads.items():
            _close(g, jg[name], 1e-5, name)


@pytest.fixture
def t2i_files(tmp_path):
    """A jsonl of 7 items: PNGs of several sizes (one twice the crop size
    or more, for the BOX halving), f16 `.npz` features of 3-10 rows (one
    longer than the window), a missing image, a corrupt image and a
    corrupt `.npz`."""
    from PIL import Image

    rng = np.random.RandomState(0)
    feat = tmp_path / "t5"
    feat.mkdir()
    rows = []
    sizes = [(40, 48), (70, 33), (33, 33), (80, 100), (36, 50), (50, 36),
             (34, 34)]
    for i, (w, h) in enumerate(sizes):
        path = tmp_path / f"img{i}.png"
        if i == 2:
            path.write_bytes(b"not a png")
        elif i != 4:  # 4: missing
            Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(path)
        n = int(rng.randint(3, 11))
        if i == 5:
            (feat / f"{10 + i}.npz").write_bytes(b"PK\x03\x04 truncated")
        else:
            np.savez(str(feat / f"{10 + i}.npz"),
                     feature=rng.randn(n, 6).astype(np.float16),
                     mask=np.ones(n, np.int32))
        rows.append({"image_path": str(path), "caption_idx": 10 + i})
    jsonl = tmp_path / "items.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(jsonl), str(feat)


@pytest.mark.parametrize("retries", [0, 3])
def test_t2i_dataset_batches_equal_jax(t2i_files, retries):
    jsonl, feat = t2i_files
    kw = dict(caption_dim=6, t5_len=8, retries=retries)
    ds, jds = T2IDataset(jsonl, feat, 32, **kw), JT2IDataset(jsonl, feat, 32,
                                                             **kw)
    got = list(ds.batches(2, seed=3, epochs=2, num_hosts=2, host_id=1))
    ref = list(jds.batches(2, seed=3, epochs=2, num_hosts=2, host_id=1))
    assert len(got) == len(ref) == 2  # host 1 of 2: 3 items, 1 batch an epoch
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    items = [ds[i] for i in range(len(ds))]
    for i, (g, r) in enumerate(zip(items, [jds[i] for i in range(len(ds))])):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    bad = [items[i][3] for i in (2, 4, 5)]
    if retries == 0:  # the dummies: valid 0, the last mask position kept
        assert bad == [0.0, 0.0, 0.0]
        assert all(items[i][2].tolist() == [0] * 7 + [1] for i in (2, 4, 5))
    assert items[0][3] == 1.0 and items[0][0].shape == (32, 32, 3)
    assert items[0][2].tolist()[-1] == 1  # left-padded: valid rows last


def test_train_t2i_cli_synthetic(tmp_path):
    state = train_t2i.main([
        "--synthetic-steps", "2", "--gpt-model", "GPT-nano",
        "--image-size", "64", "--global-batch-size", "2", "--log-every", "1",
        "--results-dir", str(tmp_path), "--device", "cpu"])
    assert state.step == 2
    assert state.model.cfg.cls_token_num == 8
    assert state.model.cfg.caption_dim == 64
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    recs = [r for r in recs if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2]
    # the reference init zeroes the head: the first loss is ln 16384
    np.testing.assert_allclose(recs[0]["loss"], np.log(16384), rtol=1e-3)
    assert (tmp_path / "checkpoints" / "step_00000002.pt").exists()


def test_train_t2i_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(ValueError, match="ranks"):  # one process: world 1
        train_t2i.main(["--synthetic-steps", "1", "--dp", "2",
                        "--device", "cpu", "--results-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="ranks"):  # a TP mesh too
        train_t2i.main(["--synthetic-steps", "1", "--tp", "2",
                        "--device", "cpu", "--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        train_t2i.main(["--gpt-model", "GPT-nano", "--image-size", "32",
                        "--device", "cpu", "--results-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_t2i.main(["--synthetic-steps", "1", "--device", "cuda",
                            "--results-dir", str(tmp_path)])
