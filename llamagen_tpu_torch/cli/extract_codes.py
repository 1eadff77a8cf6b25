"""Offline VQ tokenization of an image folder into packed code shards
(PyTorch port of `llamagen_tpu/cli/extract_codes.py`).

Center crops (or flipped pairs, or ten crops), encoded in batches by the
VQ encoder (f32), written as int16 `.codes.npy` / `.labels.npy` shards
that `llamagen_tpu_torch.data.codes.PackedCodeDataset` reads: codes [N,
L], or [N, naug, L] with `--flip-aug` (naug 2) or `--ten-crop` (naug 10).
Items are taken with a host stride (`--num-hosts`, `--host-id`).

  python -m llamagen_tpu_torch.cli.extract_codes --data-path /data/train \\
      --vq-ckpt vq_ds16_c2i.pt --image-size 256 --out-dir /data/codes256
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device, load_vq
from llamagen_tpu_torch.models.vq import VQModel


def center_crop(img, size: int) -> np.ndarray:
    """PIL image -> uint8 [size, size, 3]: halve with BOX while the short
    side is at least 2 * size, resize the short side to size (BICUBIC),
    crop the center (ADM-style)."""
    from PIL import Image

    while min(*img.size) >= 2 * size:
        img = img.resize(tuple(x // 2 for x in img.size), Image.BOX)
    scale = size / min(*img.size)
    img = img.resize(tuple(round(x * scale) for x in img.size), Image.BICUBIC)
    arr = np.array(img)
    y = (arr.shape[0] - size) // 2
    x = (arr.shape[1] - size) // 2
    return arr[y:y + size, x:x + size]


def ten_crop(arr: np.ndarray, size: int) -> List[np.ndarray]:
    """torchvision TenCrop: top-left, top-right, bottom-left, bottom-right
    and center crops of the image, then of its horizontal flip."""
    h, w = arr.shape[:2]
    y, x = (h - size) // 2, (w - size) // 2

    def five(a):
        return [a[:size, :size], a[:size, w - size:], a[h - size:, :size],
                a[h - size:, w - size:], a[y:y + size, x:x + size]]

    return five(arr) + five(arr[:, ::-1])


def crops_of(arr: np.ndarray, image_size: int, mode: str
             ) -> List[np.ndarray]:
    """The crops stored for one image: `plain` [arr], `flip` [arr, its
    mirror], `ten_crop` the ten crops of a larger center crop."""
    if mode == "ten_crop":
        return ten_crop(arr, image_size)
    if mode == "flip":
        return [arr, arr[:, ::-1]]
    return [arr]


def iter_jsonl(jsonl_path: str) -> Iterator[Tuple[str, int]]:
    """t2i jsonl rows ({image_path, caption_idx}) -> (path, caption_idx):
    the stored label is the caption index, so codes re-join their T5
    features downstream."""
    with open(jsonl_path) as f:
        for i, line in enumerate(f):
            row = json.loads(line)
            yield (row.get("image_path") or row.get("image"),
                   int(row.get("caption_idx", i)))


def iter_image_folder(root: str) -> Iterator[Tuple[str, int]]:
    """ImageFolder layout root/class_name/img.jpg; labels by sorted name."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                yield os.path.join(cdir, fname), label


@torch.no_grad()
def encode_batch(vq_model: VQModel, crops: Sequence[np.ndarray],
                 naug: int = 1) -> np.ndarray:
    """uint8 crops [N * naug] of [H, W, 3] (each image's naug crops
    together) -> int16 codes [N, h * w], or [N, naug, h * w] for naug > 1,
    on the host. Pixels go to [-1, 1] on the model's device and dtype."""
    w = vq_model.post_quant_conv.weight
    x = torch.from_numpy(np.stack(crops)).to(w.device)
    x = (x.float() / 127.5 - 1.0).to(w.dtype)
    idx = vq_model.encode(x)[2].reshape(len(crops) // naug, naug, -1)
    codes = idx.to(torch.int16).cpu().numpy()
    return codes if naug > 1 else codes[:, 0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", default=None,
                   help="ImageFolder root (class subdirs)")
    p.add_argument("--jsonl", default=None,
                   help="t2i jsonl of {image_path, caption_idx} rows")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--flip-aug", action="store_true",
                   help="store flipped codes too")
    p.add_argument("--ten-crop", action="store_true",
                   help="ten-crop augmentation")
    p.add_argument("--crop-range", type=float, default=1.1,
                   help="pre-crop scale for --ten-crop")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--shard-size", type=int, default=100_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    if args.flip_aug and args.ten_crop:
        raise SystemExit("--flip-aug and --ten-crop exclude each other")
    device = get_device(args.device)
    vq_model = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                       args.codebook_embed_dim, torch.float32, device,
                       encoder=True)
    mode = ("ten_crop" if args.ten_crop
            else "flip" if args.flip_aug else "plain")
    naug = {"ten_crop": 10, "flip": 2, "plain": 1}[mode]
    pre_size = (int(args.image_size * args.crop_range) if args.ten_crop
                else args.image_size)

    os.makedirs(args.out_dir, exist_ok=True)
    buf_codes: List[np.ndarray] = []
    buf_labels: List[int] = []
    batch_imgs: List[np.ndarray] = []
    batch_labels: List[int] = []
    shard_id = total = 0

    def flush():
        nonlocal shard_id
        if not buf_codes:
            return
        stem = os.path.join(args.out_dir,
                            f"shard_h{args.host_id:03d}_{shard_id:05d}")
        np.save(stem + ".codes.npy", np.stack(buf_codes).astype(np.int16))
        np.save(stem + ".labels.npy", np.asarray(buf_labels, np.int16))
        shard_id += 1
        buf_codes.clear()
        buf_labels.clear()

    def run_batch():
        nonlocal total
        if not batch_imgs:
            return
        buf_codes.extend(encode_batch(vq_model, batch_imgs, naug))
        buf_labels.extend(batch_labels[::naug])
        total += len(batch_imgs) // naug
        batch_imgs.clear()
        batch_labels.clear()
        if len(buf_codes) >= args.shard_size:
            flush()

    if args.jsonl:
        items = iter_jsonl(args.jsonl)
    elif args.data_path:
        items = iter_image_folder(args.data_path)
    else:
        raise SystemExit("need --data-path or --jsonl")

    for i, (path, label) in enumerate(items):
        if i % args.num_hosts != args.host_id:  # host striding
            continue
        try:
            img = Image.open(path).convert("RGB")
        except OSError:
            continue
        crops = crops_of(center_crop(img, pre_size), args.image_size, mode)
        batch_imgs.extend(crops)
        batch_labels.extend([label] * len(crops))
        if len(batch_imgs) >= args.batch_size:
            run_batch()
    run_batch()
    flush()
    print(f"extracted {total} samples into {shard_id} shards at "
          f"{args.out_dir}")
    return total


if __name__ == "__main__":
    main()
