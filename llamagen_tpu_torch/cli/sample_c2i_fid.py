"""50k-sample generation for FID evaluation, one process or one rank per
card, streamed to disk (PyTorch port of
`llamagen_tpu/cli/sample_c2i_fid.py`).

The samples are split into blocks of `--per-device-batch-size` labels,
and each block samples on its own:

  - its labels come from numpy's `RandomState(seed * 100003 + block)`
    (`block_labels`, the JAX package's), and its random draws from a
    generator on the card seeded from (seed, block) alone
    (`block_seed`), so the images do not depend on how many ranks share
    the work;
  - its tokens come from `ops/generate.py` with bf16 weights and a bf16
    KV cache (the decode-attention kernel in every layer and step), its
    images from the VQ decoder, clipped to uint8 and resized (PIL
    bicubic) to `--image-size-eval`;
  - its rows are written into a disk-backed `.npy` memmap
    (`np.lib.format.open_memmap`): the 50k x 256 x 256 x 3 array never
    lives in host memory; `--npz` zips it for the ADM evaluator.

Under torchrun, rank r of w takes the blocks r::w and, when w > 1, writes
its own `-h{r:03d}.npy` of the shared layout (its rows filled), as the
JAX package's hosts do.

  python -m llamagen_tpu_torch.cli.sample_c2i_fid --gpt-ckpt c2i_L_384.pt \\
      --vq-ckpt vq_ds16_c2i.pt --gpt-model GPT-L --image-size 384 \\
      --image-size-eval 256 --cfg-scale 2.0 --num-samples 50000
  torchrun --standalone --nproc_per_node 8 -m \\
      llamagen_tpu_torch.cli.sample_c2i_fid ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llamagen_tpu_torch.cli.common import get_device, load_gpt, load_vq
from llamagen_tpu_torch.models.gpt import Transformer
from llamagen_tpu_torch.models.vq import VQModel
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.parallel import distributed


class FidSamples(NamedTuple):
    path: str            # the .npy this process wrote
    written: int         # rows written by this process
    seconds: float       # wall time of the sampling loop


def block_labels(seed: int, block: int, bs: int, num_classes: int):
    return np.random.RandomState(seed * 100003 + block).randint(
        0, num_classes, size=(bs,)).astype(np.int32)


def block_seed(seed: int, block: int) -> int:
    """The generator seed of global sample-block `block`: a function of
    (seed, block) alone, as JAX's `fold_in(PRNGKey(seed), block)`."""
    return seed * 2 ** 32 + block


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """Decoder output in about [-1, 1] -> uint8 on the host, as JAX
    clips it."""
    return np.clip((images.float().cpu().numpy() + 1) * 127.5, 0, 255
                   ).astype(np.uint8)


def resize_bicubic(images: np.ndarray, size: int) -> np.ndarray:
    """uint8 [N, H, W, 3] -> [N, size, size, 3] through PIL's bicubic."""
    from PIL import Image

    return np.stack([np.array(Image.fromarray(im).resize(
        (size, size), Image.BICUBIC)) for im in images])


@torch.no_grad()
def sample_block(gpt: Transformer, vq_model: VQModel, labels: np.ndarray,
                 latent: int, generator: torch.Generator, **gen_kw
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: class labels [bs] -> (tokens [bs, latent * latent],
    decoded images [bs, H, W, 3] in the VQ's dtype), on the model's
    device. `gen_kw` goes to `generate` (cfg, sampling, dtypes)."""
    dev = gpt.tok_embeddings.weight.device
    cond = torch.as_tensor(labels, dtype=torch.long, device=dev)
    seq = generate(gpt, cond, max_new_tokens=latent * latent,
                   generator=generator, **gen_kw)
    imgs = vq_model.decode_code(seq.reshape(len(labels), latent, latent))
    return seq, imgs


def main(argv=None) -> FidSamples:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpt-model", default="GPT-B")
    p.add_argument("--gpt-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--image-size-eval", type=int, default=256)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--cfg-scale", type=float, default=1.5)
    p.add_argument("--cfg-interval", type=int, default=-1)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--per-device-batch-size", "--per-proc-batch-size",
                   dest="per_device_batch_size", type=int, default=32)
    p.add_argument("--num-samples", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-dir", default="samples")
    p.add_argument("--npz", action="store_true",
                   help="also zip the memmap into an ADM-style .npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = get_device(args.device)
    owned = not dist.is_initialized()
    distributed.init_distributed(device.type)
    device = distributed.local_device(device)
    rank, world = distributed.rank(), distributed.world_size()

    dtype = torch.bfloat16
    gpt = load_gpt(args.gpt_ckpt, args.gpt_model, args.image_size,
                   args.downsample_size, dtype, device)
    vq_model = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                       args.codebook_embed_dim, dtype, device)
    latent = args.image_size // args.downsample_size
    bs = args.per_device_batch_size
    gen_kw = dict(cfg_scale=args.cfg_scale, cfg_interval=args.cfg_interval,
                  temperature=args.temperature, top_k=args.top_k,
                  top_p=args.top_p, compute_dtype=dtype, cache_dtype=dtype)
    num_blocks = (args.num_samples + bs - 1) // bs

    os.makedirs(args.sample_dir, exist_ok=True)
    name = (f"{args.gpt_model}-{args.image_size}-size-{args.image_size_eval}"
            f"-cfg-{args.cfg_scale}-seed-{args.seed}")
    suffix = f"-h{rank:03d}" if world > 1 else ""
    npy_path = os.path.join(args.sample_dir, f"{name}{suffix}.npy")
    out = np.lib.format.open_memmap(
        npy_path, mode="w+", dtype=np.uint8,
        shape=(args.num_samples, args.image_size_eval,
               args.image_size_eval, 3))

    t0 = time.time()
    written = 0
    for i, b in enumerate(range(rank, num_blocks, world)):
        labels = block_labels(args.seed, b, bs, args.num_classes)
        gen = torch.Generator(device=device).manual_seed(
            block_seed(args.seed, b))
        _, imgs = sample_block(gpt, vq_model, labels, latent, gen, **gen_kw)
        start, stop = b * bs, min(b * bs + bs, args.num_samples)
        chunk = to_uint8(imgs[:stop - start])
        if args.image_size_eval != args.image_size:
            chunk = resize_bicubic(chunk, args.image_size_eval)
        out[start:stop] = chunk
        written += stop - start
        if i % 10 == 0:
            rate = written / (time.time() - t0)
            print(f"rank {rank}: {written} samples ({rate:.2f} img/s)",
                  flush=True)
    out.flush()
    seconds = time.time() - t0
    print(f"rank {rank}: wrote {written} samples to {npy_path} "
          f"({written / max(seconds, 1e-9):.2f} img/s overall)")

    if args.npz and world == 1:
        npz_path = npy_path[:-4] + ".npz"
        np.savez(npz_path, arr_0=out)
        print(f"zipped to {npz_path}")
    del out
    if owned and dist.is_initialized():
        distributed.shutdown()
    return FidSamples(npy_path, written, seconds)


if __name__ == "__main__":
    main()
