"""Class-conditional sampling CLI (PyTorch port).

Same flags and flow as `llamagen_tpu/cli/sample_c2i.py`, plus `--device`:
loads VQ + GPT checkpoints (seeded random weights when none is given;
bf16/f32 or quantised by `cli/tools.py quantize-ckpt`), samples the 8
canonical demo classes (or user classes) with CFG, decodes to images and
writes a grid png. `--draft-gpt-model` samples speculatively
(`ops/speculative.py`): the draft proposes `--spec-k` tokens per round and
the target verifies them in one forward.

  python -m llamagen_tpu_torch.cli.sample_c2i --gpt-ckpt c2i_L_384.pt \
      --vq-ckpt vq_ds16_c2i.pt --gpt-model GPT-L --image-size 384
  # self-speculation with a W4 copy of the target
  python -m llamagen_tpu_torch.cli.tools quantize-ckpt --in c2i_L_384.pt \
      --out c2i_L_384_w4.pt --mode w4 --gpt-model GPT-L --image-size 384
  python -m llamagen_tpu_torch.cli.sample_c2i --gpt-ckpt c2i_L_384.pt \
      --gpt-model GPT-L --image-size 384 --draft-gpt-model GPT-L \
      --draft-gpt-ckpt c2i_L_384_w4.pt
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import (get_device, load_gpt, load_vq,
                                           save_image_grid)
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.speculative import generate_speculative

# the reference's demo classes (sample_c2i.py:77)
DEMO_CLASSES = [207, 360, 387, 974, 88, 979, 417, 279]


class SampleResult(NamedTuple):
    tokens: np.ndarray       # [N, latent * latent]
    images: np.ndarray       # [N, H, W, 3] f32 in about [-1, 1]
    gen_seconds: float       # GPT sampling wall time (device synchronised)
    rounds: Optional[int] = None  # speculative verify rounds


def main(argv=None) -> SampleResult:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpt-model", default="GPT-B")
    p.add_argument("--gpt-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256,
                   choices=[256, 384, 512])
    p.add_argument("--downsample-size", type=int, default=16, choices=[8, 16])
    p.add_argument("--classes", type=int, nargs="*", default=DEMO_CLASSES)
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--cfg-interval", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--out", default="sample_c2i.png")
    p.add_argument("--device", default="cuda")
    p.add_argument("--draft-gpt-model", default=None,
                   help="enable speculative decoding with this draft size")
    p.add_argument("--draft-gpt-ckpt", default=None)
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per verify round")
    args = p.parse_args(argv)

    if args.draft_gpt_model and args.cfg_interval != -1:
        raise ValueError("speculative decoding does not support "
                         "--cfg-interval")
    device = get_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    gpt = load_gpt(args.gpt_ckpt, args.gpt_model, args.image_size,
                   args.downsample_size, dtype, device)
    vq = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                 args.codebook_embed_dim, dtype, device)
    latent = args.image_size // args.downsample_size
    labels = torch.tensor(args.classes, dtype=torch.long, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    draft = None
    if args.draft_gpt_model:
        draft = load_gpt(args.draft_gpt_ckpt, args.draft_gpt_model,
                         args.image_size, args.downsample_size, dtype, device)

    t0 = time.time()
    rounds = None
    if draft is not None:
        seq, rounds = generate_speculative(
            gpt, draft, labels, max_new_tokens=latent * latent,
            k=args.spec_k, generator=generator, cfg_scale=args.cfg_scale,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            compute_dtype=dtype)
    else:
        seq = generate(gpt, labels, max_new_tokens=latent * latent,
                       generator=generator, cfg_scale=args.cfg_scale,
                       cfg_interval=args.cfg_interval,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, compute_dtype=dtype,
                       cache_dtype=dtype)
    seq = seq.cpu()  # waits for the device
    gen_seconds = time.time() - t0
    if rounds is not None:
        print(f"speculative: {rounds} verify rounds for {latent * latent} "
              f"tokens ({latent * latent / max(rounds, 1):.2f} tokens/round)")
    print(f"gpt sampling takes {gen_seconds:.2f}s "
          f"({len(labels)} images, {latent}x{latent} tokens)")

    t0 = time.time()
    imgs = vq.decode_code(seq.to(device).reshape(-1, latent, latent))
    imgs = imgs.float().cpu().numpy()
    print(f"vq decoding takes {time.time() - t0:.2f}s")

    save_image_grid(imgs, args.out, nrow=4)
    print(f"saved {args.out}")
    return SampleResult(seq.numpy(), imgs, gen_seconds, rounds)


if __name__ == "__main__":
    main()
