"""VQ tokenizer reconstruction evaluation (PyTorch port of
`llamagen_tpu/cli/reconstruction_vq.py`): encode -> decode round trip of
center crops from a validation folder, per-image PSNR / SSIM, codebook
usage, and an npz of the reconstructions for rFID.

  python -m llamagen_tpu_torch.cli.reconstruction_vq --data-path /data/val \\
      --vq-ckpt vq_ds16_c2i.pt --image-size 256
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device, load_vq
from llamagen_tpu_torch.cli.extract_codes import center_crop, iter_image_folder
from llamagen_tpu_torch.eval.metrics import images_to_unit_range, psnr, ssim
from llamagen_tpu_torch.models.vq import VQModel


@torch.no_grad()
def roundtrip_batch(vq_model: VQModel, crops: Sequence[np.ndarray]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 crops [N] of [H, W, 3] -> (reconstructions f32 [N, H, W, 3]
    in the model's [-1, 1] range, code ids [N, h, w]), on the host."""
    w = vq_model.post_quant_conv.weight
    x = torch.from_numpy(np.stack(crops)).to(w.device)
    x = (x.float() / 127.5 - 1.0).to(w.dtype)
    z_q, _, idx = vq_model.encode(x)
    rec = vq_model.decode(z_q)
    return rec.float().cpu().numpy(), idx.cpu().numpy()


def score(crops: Sequence[np.ndarray], rec: np.ndarray
          ) -> Tuple[List[float], List[float], np.ndarray]:
    """Per-image PSNR and SSIM of the reconstructions against the crops,
    both in [0, 1]; and the reconstructions as uint8 (the rFID dump)."""
    unit = [images_to_unit_range(r) for r in rec]
    psnrs = [psnr(c.astype(np.float32) / 255.0, u)
             for c, u in zip(crops, unit)]
    ssims = [ssim(c.astype(np.float32) / 255.0, u)
             for c, u in zip(crops, unit)]
    return psnrs, ssims, (np.stack(unit) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-images", type=int, default=50000)
    p.add_argument("--npz-out", default=None,
                   help="write reconstructed images npz for rFID")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    device = get_device(args.device)
    vq_model = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                       args.codebook_embed_dim, torch.float32, device,
                       encoder=True)
    psnrs: List[float] = []
    ssims: List[float] = []
    dump: List[np.ndarray] = []
    used = np.zeros((vq_model.cfg.codebook_size,), bool)
    batch: List[np.ndarray] = []
    count = 0

    def run(crops):
        nonlocal count
        rec, idx = roundtrip_batch(vq_model, crops)
        used[np.unique(idx)] = True
        ps, ss, u8 = score(crops, rec)
        psnrs.extend(ps)
        ssims.extend(ss)
        if args.npz_out:
            dump.extend(u8)
        count += len(crops)

    for path, _ in iter_image_folder(args.data_path):
        if count >= args.max_images:
            break
        try:
            img = Image.open(path).convert("RGB")
        except OSError:
            continue
        batch.append(center_crop(img, args.image_size))
        if len(batch) == args.batch_size:
            run(batch)
            batch = []
    if batch and count < args.max_images:
        run(batch)

    res = {"images": count, "psnr": float(np.mean(psnrs)),
           "ssim": float(np.mean(ssims)), "codebook_usage": float(used.mean())}
    print(f"images: {count}")
    print(f"PSNR: {res['psnr']:.4f}")
    print(f"SSIM: {res['ssim']:.4f}")
    print(f"codebook usage: {res['codebook_usage']:.4f}")
    if args.npz_out:
        np.savez(args.npz_out, arr_0=np.stack(dump))
        print(f"wrote {args.npz_out} for rFID evaluation")
    return res


if __name__ == "__main__":
    main()
