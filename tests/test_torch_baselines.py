"""The port's baseline tokenizers (`models/klvae.py`,
`models/consistency_decoder.py`, the taming VQGAN on `models/vq.py`,
`utils/convert.py`'s key maps, `cli/reconstruction_baseline.py`) against
the JAX package's on the CPU.

Weights cross in the published layouts: one random state dict (LDM keys,
the openai ConvUNetVAE keys, taming keys) goes to the port's
`load_state_dict` and to JAX's converter. Tolerances, f32: outputs within
1e-4 of their largest |value| (two conv stacks that sum in different
orders); key maps and the schedule tables equal bit for bit; taming token
ids equal; the CLIs' printed PSNR / SSIM within 1e-4 (their last printed
digit). The `cd` CLI draws its noise from a generator: shapes and
finiteness only.
"""

import importlib.util
import json
import re

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.cli import reconstruction_baseline as jrb
from llamagen_tpu.models import consistency_decoder as jcd
from llamagen_tpu.models import klvae as jklvae
from llamagen_tpu.models import vq as jvq
from llamagen_tpu.utils import convert as jconvert
from llamagen_tpu_torch.cli import reconstruction_baseline as rb
from llamagen_tpu_torch.config import replace
from llamagen_tpu_torch.models import consistency_decoder as cd
from llamagen_tpu_torch.models import klvae, vq
from llamagen_tpu_torch.utils import convert
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
KL = klvae.KLVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=2,
                       z_channels=8, embed_dim=4)
JKL = jklvae.KLVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=2,
                         z_channels=8, embed_dim=4)
CD = cd.CDConfig(in_channels=7, base_ch=32, ch_mult=(1, 2, 4),
                 layers_per_block=2, time_embed_dim=64, n_timesteps=64,
                 latent_scale=2)
JCD = jcd.CDConfig(in_channels=7, base_ch=32, ch_mult=(1, 2, 4),
                   layers_per_block=2, time_embed_dim=64, n_timesteps=64,
                   latent_scale=2)
TAMING_NARROW = dict(ch=32, z_channels=32, codebook_size=64,
                     codebook_embed_dim=8, encoder_ch_mult=(1, 2),
                     decoder_ch_mult=(1, 2))
TAMING = replace(convert.taming_vq_config("vqgan_imagenet_f16_16384"),
                 **TAMING_NARROW)


@torch.no_grad()
def randomize(model, seed=0):
    """Random weights everywhere, GroupNorm affine terms included."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            fan = m.weight[0].numel()
            m.weight.normal_(0.0, fan ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.05, generator=g)
        elif isinstance(m, torch.nn.GroupNorm):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
        elif isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 0.5, generator=g)
    return model.eval()


def numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


def jtree(params):
    return jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def kl_pair():
    model = randomize(klvae.AutoencoderKL(KL), seed=1)
    return model, jtree(jconvert.convert_sd_vae(numpy_sd(model), JKL))


def _images(seed, shape=(2, 16, 16, 3)):
    return np.random.RandomState(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def test_klvae_matches_jax(kl_pair):
    model, params = kl_pair
    x = _images(0)
    mean, logvar = model.encode(torch.from_numpy(x))
    jmean, jlogvar = jklvae.encode(params, jnp.asarray(x), JKL)
    close(mean, jmean)
    close(logvar, jlogvar)
    close(model.decode(mean), jklvae.decode(params, jmean, JKL))
    close(model.roundtrip(torch.from_numpy(x)),
          jklvae.roundtrip(params, jnp.asarray(x), JKL))
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, jmean.shape, jmean.dtype))
    close(model.roundtrip(torch.from_numpy(x), noise=torch.from_numpy(noise)),
          jklvae.roundtrip(params, jnp.asarray(x), JKL, rng=key))


def test_klvae_clamps_logvar_and_samples_from_a_generator(kl_pair):
    model, _ = kl_pair
    mean = torch.zeros(1, 2, 2, 4)
    logvar = torch.full((1, 2, 2, 4), 100.0)
    z1 = model.sample(mean, logvar, torch.Generator().manual_seed(0))
    z2 = model.sample(mean, logvar, torch.Generator().manual_seed(0))
    assert torch.equal(z1, z2) and z1.abs().max() > 0
    x = torch.from_numpy(_images(1))
    _, lv = model.encode(x * 1e3)
    assert lv.min() >= -30 and lv.max() <= 20


def to_diffusers(sd, nlev):
    """LDM keys -> the diffusers AutoencoderKL layout (Linear attention)."""
    out = {}
    for k, v in sd.items():
        nk = k.replace("mid.block_1.", "mid_block.resnets.0.")
        nk = nk.replace("mid.block_2.", "mid_block.resnets.1.")
        for a, b in (("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"),
                     ("v", "to_v"), ("proj_out", "to_out.0")):
            nk = nk.replace(f"mid.attn_1.{a}.", f"mid_block.attentions.0.{b}.")
        nk = nk.replace("norm_out.", "conv_norm_out.")
        nk = nk.replace(".nin_shortcut.", ".conv_shortcut.")
        nk = re.sub(r"encoder\.down\.(\d+)\.block\.",
                    r"encoder.down_blocks.\1.resnets.", nk)
        nk = re.sub(r"encoder\.down\.(\d+)\.downsample\.",
                    r"encoder.down_blocks.\1.downsamplers.0.", nk)
        m = re.match(r"decoder\.up\.(\d+)\.(block|upsample)\.(.*)", nk)
        if m:
            lev = nlev - 1 - int(m.group(1))
            kind = "resnets" if m.group(2) == "block" else "upsamplers.0"
            nk = f"decoder.up_blocks.{lev}.{kind}.{m.group(3)}"
        if "attentions.0.to_" in nk and v.ndim == 4:
            v = v[:, :, 0, 0]
        out[nk] = v
    return out


def test_diffusers_key_map_equals_jax(kl_pair):
    model, _ = kl_pair
    ldm = numpy_sd(model)
    diff = to_diffusers(ldm, len(KL.ch_mult))
    got = convert.diffusers_vae_to_ldm_keys(diff)
    want = jconvert._diffusers_vae_to_ldm_keys(diff)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # both layouts load into the port as the same weights
    for layout in (ldm, diff, {"module." + k: v for k, v in diff.items()}):
        other = klvae.AutoencoderKL(KL)
        other.load_state_dict(convert.sd_vae_state_dict(
            {**layout, "loss.logvar": np.zeros(())}))
        for k, v in model.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), k


@pytest.fixture(scope="module")
def cd_pair():
    model = randomize(cd.ConvUNetVAE(CD), seed=2)
    return model, jtree(jconvert.convert_consistency_decoder(
        numpy_sd(model), JCD))


def test_cd_unet_matches_jax(cd_pair):
    model, params = cd_pair
    x = np.random.RandomState(0).randn(2, 16, 16, 7).astype(np.float32)
    t = np.array([3, 40])
    got = model(torch.from_numpy(x), torch.from_numpy(t))
    close(got, jcd.unet_apply(params, jnp.asarray(x), jnp.asarray(t), JCD))


def test_cd_decode_latent_matches_jax_on_its_draws(cd_pair):
    """JAX's `jax.random` draws, replayed in its split order, fed to the
    port as the noise."""
    model, params = cd_pair
    lat = np.random.RandomState(1).randn(2, 4, 4, 4).astype(np.float32)
    steps = (40, 20)
    key = jax.random.PRNGKey(2)
    want = jcd.decode_latent(params, jnp.asarray(lat), JCD, key,
                             timesteps=steps)
    shape = (2, 8, 8, 3)
    noise, rng = [], key
    for _ in steps:
        rng, r = jax.random.split(rng)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(r, shape, jnp.float32))))
    got = cd.decode_latent(model, torch.from_numpy(lat), noise=noise,
                           timesteps=steps)
    close(got, want)
    assert got.abs().max() <= 1.0
    g1 = cd.decode_latent(model, torch.from_numpy(lat),
                          torch.Generator().manual_seed(0), timesteps=steps)
    g2 = cd.decode_latent(model, torch.from_numpy(lat),
                          torch.Generator().manual_seed(0), timesteps=steps)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("which", ["default", "narrow"])
def test_schedule_tables_bit_identical(which):
    cfg, jcfg = (cd.CDConfig(), jcd.CDConfig()) if which == "default" \
        else (CD, JCD)
    got, want = cd.schedule_tables(cfg), jcd.schedule_tables(jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cd_keys_are_the_published_layout(cd_pair):
    """The converter's full-coverage check holds on the port's keys, and
    `init_weights` keeps JAX `init_params`' shapes."""
    model, params = cd_pair
    fresh = cd.init_weights(cd.ConvUNetVAE(CD))
    want = jtree(jcd.init_params(jax.random.PRNGKey(0), JCD))
    assert jax.tree.structure(want) == jax.tree.structure(params)
    got = jconvert.convert_consistency_decoder(numpy_sd(fresh), JCD)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
    with pytest.raises(RuntimeError, match="Unexpected"):
        cd.ConvUNetVAE(CD).load_state_dict(convert.consistency_decoder_state_dict(
            {**numpy_sd(model), "extra.weight": np.zeros(1)}))


def to_taming(sd, n):
    """The port's VQ keys -> taming's (LDM) layout."""
    out = {}
    for k, v in sd.items():
        for part in ("encoder", "decoder"):
            for src, dst in (("0", "block_1"), ("1", "attn_1"),
                             ("2", "block_2")):
                k = k.replace(f"{part}.mid.{src}.", f"{part}.mid.{dst}.")
        k = re.sub(r"encoder\.conv_blocks\.(\d+)\.res\.",
                   r"encoder.down.\1.block.", k)
        k = re.sub(r"encoder\.conv_blocks\.(\d+)\.", r"encoder.down.\1.", k)
        m = re.match(r"decoder\.conv_blocks\.(\d+)\.(res|attn|upsample)\.(.*)",
                     k)
        if m:
            kind = "block" if m.group(2) == "res" else m.group(2)
            k = f"decoder.up.{n - 1 - int(m.group(1))}.{kind}.{m.group(3)}"
        out[k] = v
    return out


@pytest.fixture(scope="module")
def taming_pair():
    model = randomize(vq.VQModel(TAMING, encoder=True), seed=3)
    taming = to_taming(numpy_sd(model), len(TAMING.decoder_ch_mult))
    jcfg = jax_config(TAMING)
    return model, taming, jtree(jconvert.convert_taming_vq(taming, jcfg)), \
        jcfg


def test_taming_config_equals_jax():
    for name in ("vqgan_imagenet_f16_1024", "vqgan_imagenet_f16_16384",
                 "vqgan_openimage_f8_256", "vqgan_openimage_f8_16384"):
        assert convert.taming_vq_config(name).__dict__ == \
            jconvert.taming_vq_config(name).__dict__


def test_taming_roundtrip_matches_jax(taming_pair):
    model, taming, params, jcfg = taming_pair
    sd = convert.taming_vq_state_dict({**taming, "loss.w": np.zeros(1)},
                                      TAMING)
    assert sorted(sd) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    x = _images(4)
    z_q, _, ids = model.encode(torch.from_numpy(x))
    jz, _, jids = jvq.encode(params, jnp.asarray(x), jcfg, train=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(model.decode(z_q), jvq.decode(params, jz, jcfg))
    bad = dict(taming)
    bad["encoder.down.0.attn.0.norm.weight"] = np.ones(32, np.float32)
    with pytest.raises(ValueError, match="lowest level"):
        convert.taming_vq_state_dict(bad, TAMING)


def _image_folder(tmp_path, n=2, size=40):
    from PIL import Image
    data = tmp_path / "val" / "cls"
    data.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)) \
            .save(data / f"{i}.png")
    return str(tmp_path / "val")


def _final(text):
    m = re.search(r"FINAL \((\S+)\): PSNR ([-\d.]+), SSIM ([-\d.]+) over "
                  r"(\d+) images", text)
    return float(m.group(2)), float(m.group(3)), int(m.group(4))


@pytest.mark.parametrize("backend", ["taming", "sd-vae"])
def test_reconstruction_baseline_cli_matches_jax(backend, kl_pair,
                                                 taming_pair, tmp_path,
                                                 capsys):
    data = _image_folder(tmp_path)
    ckpt = str(tmp_path / "model.ckpt")
    common = ["--data-path", data, "--image-size", "32", "--batch-size",
              "2", "--max-images", "2", "--backend", backend,
              "--ckpt", ckpt]
    if backend == "taming":
        sd = taming_pair[1]
        overrides = dict(TAMING_NARROW)
        common += ["--taming-overrides", json.dumps(overrides)]
    else:
        sd = numpy_sd(kl_pair[0])
        common += ["--vae-config", json.dumps(
            {"ch": 32, "ch_mult": [1, 2], "z_channels": 8,
             "embed_dim": 4})]
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, ckpt)
    jrb.main(common)
    want = _final(capsys.readouterr().out)
    npz = str(tmp_path / "rec.npz")
    res = rb.main(common + ["--device", "cpu", "--npz-out", npz])
    got = _final(capsys.readouterr().out)
    assert got[2] == want[2] == res["images"] == 2
    assert abs(got[0] - want[0]) <= 1e-4 + 1e-9
    assert abs(got[1] - want[1]) <= 1e-4 + 1e-9
    assert np.load(npz)["arr_0"].shape == (2, 32, 32, 3)


def test_reconstruction_baseline_cd_runs(kl_pair, tmp_path):
    """The sampler's default timesteps (1008, 512) on a 1024-step table."""
    data = _image_folder(tmp_path)
    vae_ckpt, cd_ckpt = str(tmp_path / "vae.pt"), str(tmp_path / "cd.pt")
    torch.save(kl_pair[0].state_dict(), vae_ckpt)
    unet = randomize(cd.ConvUNetVAE(replace(CD, n_timesteps=1024)), seed=4)
    torch.save({"state_dict": unet.state_dict()}, cd_ckpt)
    npz = str(tmp_path / "rec.npz")
    res = rb.main([
        "--backend", "cd", "--ckpt", cd_ckpt, "--vae-ckpt", vae_ckpt,
        "--vae-config", '{"ch": 32, "ch_mult": [1, 2], "z_channels": 8, '
        '"embed_dim": 4}',
        "--cd-config", json.dumps({"base_ch": 32, "ch_mult": [1, 2, 4],
                                   "layers_per_block": 2,
                                   "time_embed_dim": 64, "n_timesteps": 1024,
                                   "latent_scale": 2}),
        "--data-path", data, "--image-size", "32", "--batch-size", "2",
        "--device", "cpu", "--npz-out", npz])
    rec = np.load(npz)["arr_0"]
    assert rec.shape == (2, 32, 32, 3) and rec.dtype == np.uint8
    assert res["images"] == 2
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])


def test_consistency_backend_is_reachable(tmp_path):
    """JAX's CLI lists `consistency` in its docstring but not in its
    choices (ROADMAP F10); the port's takes it and needs diffusers."""
    argv = ["--backend", "consistency", "--ckpt", str(tmp_path / "none"),
            "--data-path", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        jrb.main(argv)
    assert e.value.code == 2
    if importlib.util.find_spec("diffusers") is None:
        with pytest.raises(SystemExit, match="diffusers"):
            rb.main(argv + ["--device", "cpu"])
    else:
        with pytest.raises(OSError):
            rb.main(argv + ["--device", "cpu"])
