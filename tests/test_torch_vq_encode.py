"""Port VQ encoder and quantizer (llamagen_tpu_torch.models.vq) against the
JAX package on the CPU, f32, on weights carried by
`vq_state_dict_from_jax`, at narrow widths (ch 32).

Tolerances: encoder features within 1e-4 of the largest magnitude (f32
sums of ~30 convolutions in another order); token ids bit-identical (the
JAX suite's own VQ standard, PARITY.md:11); `quantize` losses within 1e-6
relative, the straight-through gradients within 1e-5 of their largest
magnitude (the entropy loss divides the f32 distances by T = 0.01, which
scales their rounding by 100); `decode(z_q)` and `forward` images within
5e-4 (the PARITY.md VQ tolerance, as the decoder's test); the `forward`
losses within 1e-4 relative (they pass through the encoder's f32
rounding)."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import vq as jvq
from llamagen_tpu_torch.config import VQConfig, vq_config
from llamagen_tpu_torch.models import vq
from llamagen_tpu_torch.utils.convert import vq_state_dict_from_jax
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vq import SMALL

# narrow layouts of the released tokenizers: VQ-16 (16x down) and VQ-8
NARROW = {name: dataclasses.replace(vq_config(name), ch=32, z_channels=64,
                                    codebook_size=512)
          for name in ("VQ-16", "VQ-8")}


def make_vq_pair(cfg, seed=0):
    """JAX VQ params (f32) and the whole port model on the same weights."""
    params = jvq.init_params(jax.random.PRNGKey(seed), jax_config(cfg))
    model = vq.VQModel(cfg, encoder=True)
    model.load_state_dict(vq_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg))  # strict: every key
    return params, model.eval()


def images(b, size, seed=1):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", sorted(NARROW))
def test_encoder_features_match_jax(name):
    cfg = NARROW[name]
    params, model = make_vq_pair(cfg)
    x = images(2, 32)
    ref = np.asarray(jvq.encoder_apply(params["encoder"], jnp.asarray(x),
                                       jax_config(cfg)))
    with torch.no_grad():
        out = model.encoder(torch.tensor(x).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    f = cfg.downsample_factor
    assert out.shape == ref.shape == (2, 32 // f, 32 // f, cfg.z_channels)
    assert _rel(out, ref) <= 1e-4


def test_downsample_pads_bottom_and_right_only():
    """NCHW pad (0, 1, 0, 1): one zero row below and one zero column to
    the right, then a VALID stride-2 conv, as JAX's NHWC downsample."""
    params = {"conv": jvq._conv_init(jax.random.PRNGKey(3), 3, 3, 32, 32)}
    x = np.random.RandomState(0).randn(1, 7, 6, 32).astype(np.float32)
    ref = np.asarray(jvq.downsample(params, jnp.asarray(x)))
    m = vq.Downsample(32)
    with torch.no_grad():
        m.conv.weight.copy_(torch.tensor(np.transpose(
            np.asarray(params["conv"]["kernel"]), (3, 2, 0, 1))))
        m.conv.bias.copy_(torch.tensor(np.asarray(params["conv"]["bias"])))
        out = m(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (1, 3, 3, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("entropy", [0.0, 0.1], ids=["plain", "entropy"])
def test_quantize_matches_jax(entropy):
    """ids bit-identical, the three train losses, and the straight-through
    gradient of a loss on z_q and the losses, with respect to z and the
    codebook (jax.grad against autograd)."""
    cfg = dataclasses.replace(SMALL, entropy_loss_ratio=entropy)
    jcfg = jax_config(cfg)
    rng = np.random.RandomState(2)
    z = rng.randn(2, 4, 4, cfg.codebook_embed_dim).astype(np.float32)
    cb = rng.uniform(-1, 1, (cfg.codebook_size, cfg.codebook_embed_dim)
                     ).astype(np.float32)
    w = rng.randn(*z.shape).astype(np.float32)

    def jloss(zz, codebook):
        zq, losses, idx = jvq.quantize({"codebook": codebook}, zz, jcfg,
                                       train=True)
        return (jnp.sum(zq * w) + losses["vq"] + losses["commit"]
                + losses["entropy"]), (losses, idx)

    (_, (jl, jidx)), (jgz, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))

    tz = torch.tensor(z, requires_grad=True)
    tc = torch.tensor(cb, requires_grad=True)
    zq, losses, idx = vq.quantize(tc, tz, cfg, train=True)
    total = (zq * torch.tensor(w)).sum() + sum(losses.values())
    total.backward()
    assert idx.shape == (2, 4, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for key in ("vq", "commit", "entropy"):
        np.testing.assert_allclose(losses[key].item(), float(jl[key]),
                                   rtol=1e-6, atol=1e-9, err_msg=key)
    assert (losses["entropy"].item() != 0.0) == (entropy > 0)
    assert _rel(tz.grad.numpy(), jgz) <= 1e-5
    assert _rel(tc.grad.numpy(), jgc) <= 1e-5
    # eval: no losses, z_q on unit-norm codebook rows
    zq, losses, _ = vq.quantize(tc, tz, cfg)
    assert losses == {}
    np.testing.assert_allclose(zq.norm(dim=-1).detach().numpy(), 1.0,
                               atol=1e-6)


def test_quantize_first_index_on_ties():
    """Two equal codebook rows: argmin takes the first, as jnp.argmin."""
    cfg = SMALL
    cb = np.random.RandomState(0).randn(cfg.codebook_size,
                                        cfg.codebook_embed_dim
                                        ).astype(np.float32)
    cb[7] = cb[3]
    z = cb[[3, 7, 3]].reshape(1, 1, 3, -1)
    _, _, idx = vq.quantize(torch.tensor(cb), torch.tensor(z), cfg)
    _, _, jidx = jvq.quantize({"codebook": jnp.asarray(cb)}, jnp.asarray(z),
                              jax_config(cfg))
    assert idx.tolist() == [[[3, 3, 3]]] == np.asarray(jidx).tolist()


@pytest.mark.parametrize("name", sorted(NARROW))
def test_encode_ids_bit_identical_and_roundtrip(name):
    cfg = NARROW[name]
    params, model = make_vq_pair(cfg)
    jcfg = jax_config(cfg)
    x = images(3, 64, seed=4)
    jzq, _, jidx = jvq.encode(params, jnp.asarray(x), jcfg)
    jrec, jlosses, _ = jvq.forward(params, jnp.asarray(x), jcfg, train=True)
    with torch.no_grad():
        zq, _, idx = model.encode(torch.tensor(x))
        rec = model.decode(torch.tensor(np.asarray(jzq)))
        frec, losses, fidx = model(torch.tensor(x))
    f = cfg.downsample_factor
    assert idx.shape == (3, 64 // f, 64 // f)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(fidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(zq.numpy(), np.asarray(jzq), atol=1e-6)
    assert rec.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=5e-4,
                               rtol=0)
    np.testing.assert_allclose(frec.numpy(), np.asarray(jrec), atol=5e-4,
                               rtol=0)
    for key in ("vq", "commit", "entropy"):
        np.testing.assert_allclose(losses[key].item(), float(jlosses[key]),
                                   rtol=1e-4, atol=1e-9, err_msg=key)


def test_whole_and_decode_half_loading():
    """The whole state dict loads into VQModel(cfg, encoder=True); its
    decode half into a decode-only VQModel, which refuses to encode; the
    same seed gives both the same decode half."""
    cfg = SMALL
    params = jvq.init_params(jax.random.PRNGKey(0), jax_config(cfg))
    sd = vq_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    whole = vq.VQModel(cfg, encoder=True)
    assert set(whole.state_dict()) == set(sd)
    half = vq.VQModel(cfg)
    half.load_state_dict(vq.decode_half(sd))
    with pytest.raises(ValueError, match="decode half"):
        half.encode(torch.zeros(1, 16, 16, 3))
    a = vq.init_weights(vq.VQModel(cfg), seed=3).state_dict()
    b = vq.init_weights(vq.VQModel(cfg, encoder=True), seed=3).state_dict()
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def test_resnet_dropout_only_with_a_generator():
    cfg = dataclasses.replace(SMALL, dropout_p=0.5)
    model = vq.init_weights(vq.VQModel(cfg, encoder=True), seed=0)
    x = torch.tensor(images(1, 16))
    with torch.no_grad():
        a = model.encode(x)[0]
        b = model.encode(x, train=False,
                         generator=torch.Generator().manual_seed(0))[0]
        c = model.encode(x, train=True,
                         generator=torch.Generator().manual_seed(0))[0]
        d = model.encode(x, train=True,
                         generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    assert VQConfig().dropout_p == 0.0
