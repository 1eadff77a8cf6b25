"""Single-image VQ reconstruction demo (PyTorch port of
`llamagen_tpu/cli/vq_demo.py`): encode one image to codes, decode them,
save the reconstruction as `<image stem><suffix>.png`.

  python -m llamagen_tpu_torch.cli.vq_demo --image cat.png --vq-ckpt vq.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import _png, get_device, load_vq
from llamagen_tpu_torch.cli.extract_codes import center_crop
from llamagen_tpu_torch.cli.reconstruction_vq import roundtrip_batch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--suffix", default="_rec")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    device = get_device(args.device)
    vq_model = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                       args.codebook_embed_dim, torch.float32, device,
                       encoder=True)
    crop = center_crop(Image.open(args.image).convert("RGB"),
                       args.image_size)
    rec, idx = roundtrip_batch(vq_model, [crop])
    rgb = np.clip((rec[0] + 1) * 127.5, 0, 255).astype(np.uint8)
    out = args.image.rsplit(".", 1)[0] + args.suffix + ".png"
    with open(out, "wb") as f:
        f.write(_png(rgb))
    print(f"codes: {idx.shape[1]}x{idx.shape[2]}, unique: "
          f"{len(np.unique(idx))}")
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
