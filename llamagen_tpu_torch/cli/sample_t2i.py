"""Text-conditional sampling CLI (PyTorch port).

Same flags and flow as `llamagen_tpu/cli/sample_t2i.py`, plus `--device`:
T5-encodes the prompts (`--t5-path`, a local flan-t5-xl directory; without
it, seeded random caption embeddings), left-pads them, samples with CFG
(`--draft-gpt-model`: speculatively), decodes with the VQ model and writes
a grid png. Without checkpoints the GPT and the VQ model get seeded random
weights.

  python -m llamagen_tpu_torch.cli.sample_t2i --gpt-ckpt t2i_XL_stage1_256.pt \
      --vq-ckpt vq_ds16_t2i.pt --t5-path /path/to/flan-t5-xl
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import (get_device, load_gpt, load_vq,
                                           save_image_grid)
from llamagen_tpu_torch.cli.sample_c2i import SampleResult
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.speculative import generate_speculative
from llamagen_tpu_torch.text.t5 import T5TextEncoder, left_pad_embeddings

DEMO_PROMPTS = [
    "A portrait photo of a kangaroo wearing an orange hoodie and blue "
    "sunglasses standing on the grass in front of the Sydney Opera House "
    "holding a sign on the chest that says Welcome Friends!",
    "A blue Porsche 356 parked in front of a yellow brick wall.",
    "A photo of an astronaut riding a horse in the forest. There is a "
    "river in front of them with water lilies.",
    "A map of the United States made out of sushi. It is on a table next "
    "to a glass of red wine.",
]


def main(argv=None) -> SampleResult:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpt-model", default="GPT-XL")
    p.add_argument("--gpt-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256,
                   choices=[256, 384, 512])
    p.add_argument("--downsample-size", type=int, default=16, choices=[8, 16])
    p.add_argument("--prompts", nargs="*", default=DEMO_PROMPTS)
    p.add_argument("--t5-path", required=False, default=None,
                   help="local flan-t5-xl checkpoint dir")
    p.add_argument("--cls-token-num", type=int, default=120)
    p.add_argument("--cfg-scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top-k", type=int, default=1000)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--out", default="sample_t2i.png")
    p.add_argument("--device", default="cuda")
    p.add_argument("--draft-gpt-model", default=None,
                   help="enable speculative decoding with this draft size")
    p.add_argument("--draft-gpt-ckpt", default=None)
    p.add_argument("--spec-k", type=int, default=4)
    args = p.parse_args(argv)

    device = get_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    gpt = load_gpt(args.gpt_ckpt, args.gpt_model, args.image_size,
                   args.downsample_size, dtype, device, model_type="t2i",
                   cls_token_num=args.cls_token_num)
    vq = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                 args.codebook_embed_dim, dtype, device)
    latent = args.image_size // args.downsample_size

    if args.t5_path:
        t5 = T5TextEncoder(args.t5_path, model_max_length=args.cls_token_num,
                           device=device)
        emb, mask = t5.get_text_embeddings(args.prompts)
        emb, mask = left_pad_embeddings(emb.float().cpu().numpy(),
                                        mask.cpu().numpy())
    else:
        print("WARNING: no --t5-path; using random caption embeddings")
        rng = np.random.RandomState(args.seed)
        emb = rng.randn(len(args.prompts), args.cls_token_num,
                        gpt.cfg.caption_dim).astype(np.float32)
        mask = np.ones((len(args.prompts), args.cls_token_num), np.int32)
    emb = torch.as_tensor(emb).to(device, dtype)
    mask = torch.as_tensor(mask).to(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    kw = dict(max_new_tokens=latent * latent, emb_masks=mask,
              generator=generator, cfg_scale=args.cfg_scale,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, compute_dtype=dtype)

    t0 = time.time()
    rounds = None
    if args.draft_gpt_model:
        draft = load_gpt(args.draft_gpt_ckpt, args.draft_gpt_model,
                         args.image_size, args.downsample_size, dtype, device,
                         model_type="t2i", cls_token_num=args.cls_token_num)
        seq, rounds = generate_speculative(gpt, draft, emb, k=args.spec_k,
                                           **kw)
    else:
        seq = generate(gpt, emb, cache_dtype=dtype, **kw)
    seq = seq.cpu()  # waits for the device
    gen_seconds = time.time() - t0
    if rounds is not None:
        print(f"speculative: {rounds} verify rounds "
              f"({latent * latent / max(rounds, 1):.2f} tokens/round)")
    print(f"gpt sampling takes {gen_seconds:.2f}s "
          f"({len(args.prompts)} images, {latent}x{latent} tokens)")

    imgs = vq.decode_code(seq.to(device).reshape(-1, latent, latent))
    imgs = imgs.float().cpu().numpy()
    save_image_grid(imgs, args.out, nrow=2)
    print(f"saved {args.out}")
    return SampleResult(seq.numpy(), imgs, gen_seconds, rounds)


if __name__ == "__main__":
    main()
