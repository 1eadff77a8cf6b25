"""Baseline-tokenizer reconstruction comparison rig (SD-VAE, consistency
decoder, taming VQGAN), on the card (PyTorch port of
`llamagen_tpu/cli/reconstruction_baseline.py`).

Equivalent of upstream LlamaGen's comparison rigs
(`tokenizer/vae/reconstruction_vae_ddp.py`, `tokenizer/
consistencydecoder/reconstruction_cd_ddp.py`, `tokenizer/vqgan/
reconstruction_vqgan_ddp.py`): roundtrip a validation folder through a
baseline autoencoder and report PSNR / SSIM (+ an npz for rFID) on the
protocol of `cli/reconstruction_vq.py`, so tokenizers compare
apples-to-apples.

Backends:
  taming       CompVis taming-transformers VQGAN checkpoint, run on the
               port's VQ (`models/vq.py`) through
               `utils/convert.py::taming_vq_state_dict`
  sd-vae       AutoencoderKL on the port's `models/klvae.py` (a diffusers
               or LDM-layout checkpoint, `utils/convert.py::
               sd_vae_state_dict`); the mean latent (metric stability)
  cd           the OpenAI consistency decoder on the port's
               `models/consistency_decoder.py` (2-step sampler), the
               SD-VAE encoder from --vae-ckpt; its draws from a generator
               seeded with 0
  consistency  diffusers' ConsistencyDecoderVAE (needs the diffusers
               package and local weights)

  python -m llamagen_tpu_torch.cli.reconstruction_baseline --backend taming \\
      --ckpt vqgan_imagenet_f16_16384.ckpt --data-path /data/val
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device
from llamagen_tpu_torch.cli.extract_codes import center_crop, iter_image_folder
from llamagen_tpu_torch.config import replace
from llamagen_tpu_torch.eval.metrics import psnr, ssim
from llamagen_tpu_torch.utils import convert

Roundtrip = Callable[[np.ndarray], np.ndarray]


def load_state_dict(path: str) -> Dict[str, object]:
    """A `.safetensors` -> {name: array}, or a `.pt` / `.ckpt` (its
    `state_dict` entry where it has one) -> {name: tensor}; the
    `utils/convert.py` loaders take either."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _json_config(text, tuple_keys):
    cfg = json.loads(text) if text else {}
    for k in tuple_keys:
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    return cfg


def _on(device: torch.device, fn) -> Roundtrip:
    """[B, H, W, 3] f32 in [-1, 1] on the host -> f32 host output."""
    @torch.no_grad()
    def run(batch):
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        return fn(x).float().cpu().numpy()
    return run


def taming_roundtrip(ckpt: str, taming_name: str, overrides=None,
                     device="cuda") -> Roundtrip:
    from llamagen_tpu_torch.models.vq import VQModel

    cfg = convert.taming_vq_config(taming_name)
    if overrides:
        cfg = replace(cfg, **overrides)
    model = VQModel(cfg, encoder=True)
    model.load_state_dict(convert.taming_vq_state_dict(
        load_state_dict(ckpt), cfg))
    model.to(device).eval()
    return _on(torch.device(device),
               lambda x: model.decode(model.encode(x)[0]))


def _klvae(ckpt: str, vae_config, device):
    from llamagen_tpu_torch.models import klvae

    model = klvae.AutoencoderKL(klvae.KLVAEConfig(**(vae_config or {})))
    model.load_state_dict(convert.sd_vae_state_dict(load_state_dict(ckpt)))
    return model.to(device).eval()


def sd_vae_roundtrip(ckpt: str, vae_config=None,
                     device="cuda") -> Roundtrip:
    """The deterministic mean-latent roundtrip."""
    model = _klvae(ckpt, vae_config, device)
    return _on(torch.device(device), model.roundtrip)


def cd_roundtrip(ckpt: str, vae_ckpt: str, vae_config=None, cd_config=None,
                 seed: int = 0, device="cuda") -> Roundtrip:
    """SD-VAE encode, a sampled latent, the 2-step consistency decode; one
    generator on the device, consumed batch by batch."""
    from llamagen_tpu_torch.models import consistency_decoder as cd_lib

    vae = _klvae(vae_ckpt, vae_config, device)
    cd = cd_lib.ConvUNetVAE(cd_lib.CDConfig(**(cd_config or {})))
    cd.load_state_dict(convert.consistency_decoder_state_dict(
        load_state_dict(ckpt)))
    cd.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)

    def fn(x):
        mean, logvar = vae.encode(x)
        z = vae.sample(mean, logvar, gen)
        return cd_lib.decode_latent(cd, z, gen)

    return _on(torch.device(device), fn)


def diffusers_roundtrip(kind: str, ckpt: str, device="cuda") -> Roundtrip:
    try:
        from diffusers import ConsistencyDecoderVAE
        model = ConsistencyDecoderVAE.from_pretrained(
            ckpt, local_files_only=True)
    except ImportError as e:
        raise SystemExit(
            f"backend '{kind}' needs the diffusers package and local "
            f"weights ({e}); use --backend taming, sd-vae or cd, or supply "
            f"weights offline")
    model.to(device).eval()

    def fn(x):
        lat = model.encode(x.permute(0, 3, 1, 2)).latent_dist.sample()
        return model.decode(lat).sample.permute(0, 2, 3, 1)

    return _on(torch.device(device), fn)


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", required=True,
                   choices=["taming", "sd-vae", "cd", "consistency"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--taming-config", default="vqgan_imagenet_f16_16384")
    p.add_argument("--taming-overrides", default=None,
                   help="json dict of VQConfig overrides (tests)")
    p.add_argument("--vae-config", default=None,
                   help="json dict of KLVAEConfig overrides (sd-vae/cd)")
    p.add_argument("--vae-ckpt", default=None,
                   help="cd backend: SD-VAE encoder checkpoint")
    p.add_argument("--cd-config", default=None,
                   help="json dict of CDConfig overrides (cd)")
    p.add_argument("--data-path", required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-images", type=int, default=50000)
    p.add_argument("--npz-out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    device = get_device(args.device)
    if args.backend == "taming":
        roundtrip = taming_roundtrip(
            args.ckpt, args.taming_config,
            _json_config(args.taming_overrides,
                         ("encoder_ch_mult", "decoder_ch_mult")), device)
    elif args.backend == "sd-vae":
        roundtrip = sd_vae_roundtrip(
            args.ckpt, _json_config(args.vae_config, ("ch_mult",)), device)
    elif args.backend == "cd":
        assert args.vae_ckpt, "--backend cd needs --vae-ckpt (encoder)"
        roundtrip = cd_roundtrip(
            args.ckpt, args.vae_ckpt,
            _json_config(args.vae_config, ("ch_mult",)),
            _json_config(args.cd_config, ("ch_mult",)), device=device)
    else:
        roundtrip = diffusers_roundtrip(args.backend, args.ckpt, device)

    psnrs, ssims, recon_images = [], [], []
    batch, n = [], 0
    want_npz = args.npz_out is not None
    model_seconds = 0.0

    def run_batch():
        nonlocal n, model_seconds
        if not batch:
            return
        x = np.stack(batch).astype(np.float32) / 127.5 - 1.0
        t0 = time.time()
        recon = np.clip(roundtrip(x), -1, 1)
        model_seconds += time.time() - t0
        for orig, rec in zip(x, recon):
            o = (orig + 1) / 2
            r = (rec + 1) / 2
            psnrs.append(psnr(o, r))
            ssims.append(ssim(o, r))
            if want_npz:
                recon_images.append((r * 255).astype(np.uint8))
        n += len(batch)
        batch.clear()
        print(f"{n} images: PSNR {np.mean(psnrs):.3f} "
              f"SSIM {np.mean(ssims):.4f}", flush=True)

    for path, _ in iter_image_folder(args.data_path):
        if n + len(batch) >= args.max_images:
            break
        try:
            img = Image.open(path).convert("RGB")
        except OSError:
            continue
        batch.append(center_crop(img, args.image_size))
        if len(batch) >= args.batch_size:
            run_batch()
    run_batch()

    res = {"images": n, "psnr": float(np.mean(psnrs)),
           "ssim": float(np.mean(ssims)),
           "seconds_per_image": model_seconds / max(n, 1)}
    print(f"FINAL ({args.backend}): PSNR {res['psnr']:.4f}, "
          f"SSIM {res['ssim']:.5f} over {n} images "
          f"({res['seconds_per_image']:.4f} s per image in the model)")
    if want_npz:
        np.savez(args.npz_out, arr_0=np.stack(recon_images))
        print(f"wrote {args.npz_out} for rFID")
    return res


if __name__ == "__main__":
    main()
