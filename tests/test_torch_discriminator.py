"""Port VQ-GAN discriminators (llamagen_tpu_torch.models.discriminator)
against the JAX package on the CPU, on weights carried by
`patchgan_state_dict_from_jax` / `stylegan_state_dict_from_jax`.

Tolerances: f32 logits within 2e-4 absolute + 1e-3 relative (the JAX
suite's own bound, tests/test_vq_training.py:41); with bf16 inputs (both
sides cast their f32 weights to the input's dtype per op) within 2^-6 of
the largest logit (four bf16 ulps; the last layers' roundings differ);
f32 gradients (parameters and images) of randomly signed logits within
1e-5 of the largest; BatchNorm's output within 1e-5 (f32) and one bf16 ulp
of its range (bf16), its running buffers untouched.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import discriminator as jdisc
from llamagen_tpu.utils.convert import convert_stylegan
from llamagen_tpu_torch.models import discriminator as disc
from llamagen_tpu_torch.utils.convert import (patchgan_state_dict_from_jax,
                                              stylegan_state_dict_from_jax)
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vq_encode import images

STYLEGAN_SIZE = 16  # two residual blocks (16 -> 8 -> 4) at 512 channels


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def make_pair(kind, seed=0):
    """JAX discriminator params (f32) and the port model on the same
    weights (strict load: every upstream key)."""
    key = jax.random.PRNGKey(seed)
    if kind == "patchgan":
        params = jax.jit(jdisc.init_patchgan)(key)
        model = disc.PatchGAN()
        model.load_state_dict(patchgan_state_dict_from_jax(_np(params)))
    else:
        params = jax.jit(jdisc.init_stylegan, static_argnames="image_size")(
            key, image_size=STYLEGAN_SIZE)
        model = disc.StyleGAN(image_size=STYLEGAN_SIZE)
        model.load_state_dict(stylegan_state_dict_from_jax(_np(params)))
    return params, model


# the JAX references jitted: one program each, not one per op
CASES = {"patchgan": (jax.jit(jdisc.patchgan_apply), 4, 32),
         "stylegan": (jax.jit(jdisc.stylegan_apply), 2, STYLEGAN_SIZE)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_logits_match_jax(kind, dtype):
    apply, b, size = CASES[kind]
    params, model = make_pair(kind)
    x = images(b, size, seed=5)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(apply(params, jnp.asarray(x).astype(jd)), np.float32)
    with torch.no_grad():
        out = model(torch.tensor(x).to(td))
    # PatchGAN keeps the input's dtype; JAX's StyleGAN promotes to f32
    # after its first block (its residual scale is an f32 scalar)
    want = torch.float32 if kind == "stylegan" else td
    assert out.dtype == want
    out = out.float().numpy()
    assert out.shape == ref.shape == ((b, 2, 2, 1) if kind == "patchgan"
                                      else (b, 1))
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)
    else:
        assert np.abs(out - ref).max() <= 2 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("kind", sorted(CASES))
def test_gradients_match_jax(kind):
    """f32 gradients of the logits weighted by random signs (no batch-mean
    cancellation) with respect to every parameter and the images, within
    1e-5 of the largest."""
    apply, b, size = CASES[kind]
    params, model = make_pair(kind)
    x = images(b, size, seed=7)
    shape = (b, 2, 2, 1) if kind == "patchgan" else (b, 1)
    w = np.random.RandomState(8).choice([-1.0, 1.0], shape) \
        .astype(np.float32)
    jg, jx = jax.jit(jax.grad(lambda p, xx: jnp.sum(apply(p, xx) * w),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    conv = (patchgan_state_dict_from_jax if kind == "patchgan"
            else stylegan_state_dict_from_jax)
    ref = conv(_np(jg))
    xt = torch.tensor(x, requires_grad=True)
    (model(xt) * torch.tensor(w)).sum().backward()
    gmax = max(ref[n].abs().max().item() for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= 1e-5 * gmax, f"{name}: {err:.3g} of {gmax:.3g}"
    jx = np.asarray(jx)
    assert np.abs(xt.grad.numpy() - jx).max() <= 1e-5 * np.abs(jx).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_uses_batch_statistics(dtype):
    """Train-mode statistics over (N, H, W) with a biased variance, in
    f32, in any module mode; the running buffers stay as loaded."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 16) * 3 + 1).astype(np.float32)  # NHWC
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    ref = np.asarray(jdisc._batch_norm({"scale": jnp.asarray(scale),
                                        "bias": jnp.asarray(bias)},
                                       jnp.asarray(x).astype(jd)),
                     np.float32)
    bn = disc.BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(td)
    for mode in (bn.train, bn.eval):
        mode()
        with torch.no_grad():
            out = bn(xt)
        assert out.dtype == td
        out = out.float().permute(0, 2, 3, 1).numpy()
        tol = 1e-5 if dtype == "f32" else 2 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert torch.equal(bn.running_mean, torch.zeros(16))
    assert torch.equal(bn.running_var, torch.ones(16))
    assert int(bn.num_batches_tracked) == 0


def test_stylegan_fc1_flatten_order():
    """F8 (ROADMAP Queue 3): JAX flattens the final [B, 4, 4, C] map in
    NHWC order, upstream [B, C, 4, 4] in NCHW, and JAX `convert_stylegan`
    transposes `final_linear.0.weight` without reordering its input rows.
    On an upstream-layout state dict (the port's, random weights) JAX
    therefore computes another function than upstream; with the rows
    reordered from (c, h, w) to (h, w, c) it computes the same one, and
    `stylegan_state_dict_from_jax` undoes that reorder."""
    model = disc.init_weights(disc.StyleGAN(image_size=STYLEGAN_SIZE),
                              seed=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    x = images(2, STYLEGAN_SIZE, seed=6)
    with torch.no_grad():
        upstream = model(torch.tensor(x)).numpy()
    converted = convert_stylegan(sd)
    as_jax = np.asarray(jdisc.stylegan_apply(converted, jnp.asarray(x)))
    assert np.abs(as_jax - upstream).max() > 0.1 * np.abs(upstream).max()

    w = sd["final_linear.0.weight"]  # [out, (c, h, w)]
    c = w.shape[1] // 16
    converted["fc1"]["kernel"] = \
        w.reshape(-1, c, 4, 4).transpose(2, 3, 1, 0).reshape(16 * c, -1)
    reordered = np.asarray(jdisc.stylegan_apply(converted, jnp.asarray(x)))
    np.testing.assert_allclose(reordered, upstream, atol=2e-4, rtol=1e-3)
    back = stylegan_state_dict_from_jax(_np(converted))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_upstream_keys_and_seeded_init():
    """Upstream's key layouts (what JAX `convert_patchgan` /
    `convert_stylegan` read), and JAX's init schemes from a seed."""
    pg = disc.make_discriminator("patchgan", seed=1)
    keys = set(pg.state_dict())
    assert {"main.0.weight", "main.0.bias", "main.2.weight",
            "main.3.running_var", "main.9.weight", "main.11.weight",
            "main.11.bias"} <= keys and "main.2.bias" not in keys
    sg = disc.make_discriminator("stylegan", image_size=256, seed=1)
    assert len(sg.blocks) == 2 + 6  # conv, leaky, 256 -> 4 px
    assert sg.final_linear[0].weight.shape == (512, 512 * 16)
    assert "blocks.2.downsample.0.f" in sg.state_dict()
    again = disc.make_discriminator("patchgan", seed=1).state_dict()
    for k, v in pg.state_dict().items():
        assert torch.equal(v, again[k]), k
    w = pg.main[0].weight
    assert abs(w.std().item() - 0.02) < 2e-3 and w.mean().abs() < 2e-3
    bn = pg.main[3].weight
    assert abs(bn.mean().item() - 1.0) < 1e-2 and torch.all(pg.main[3].bias
                                                          == 0)
    conv = sg.blocks[2].net[0]
    bound = (3 / conv.weight[0].numel()) ** 0.5
    assert conv.weight.abs().max() <= bound
    assert conv.weight.abs().max() > 0.9 * bound
    with pytest.raises(ValueError, match="unknown discriminator"):
        disc.make_discriminator("nope")
