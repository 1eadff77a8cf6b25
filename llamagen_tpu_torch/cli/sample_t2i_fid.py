"""Batch t2i sampling over a prompt file for FID / CLIP evaluation
(PyTorch port of `llamagen_tpu/cli/sample_t2i_fid.py`).

Equivalent of upstream LlamaGen's `autoregressive/sample/
sample_t2i_ddp.py`: reads PartiPrompts.tsv / coco captions / jsonl / txt
prompts, samples with CFG (bf16 weights and KV cache, left-padded
captions: the decode-attention kernel skips each row's pad rows), writes
one PNG per prompt and `result.jsonl` ({id, prompt, image}).

  python -m llamagen_tpu_torch.cli.sample_t2i_fid \\
      --prompt-file coco_captions.csv --gpt-ckpt t2i_XL.pt \\
      --vq-ckpt vq_ds16_t2i.pt --t5-path /t5

`--random-t5` replaces the T5 encoder by caption embeddings seeded from
each prompt's crc32 (the JAX package's stub, so the embeddings equal
its own): offline end-to-end runs.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from typing import List, NamedTuple

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device, load_gpt, load_vq
from llamagen_tpu_torch.cli.extract_t5_features import read_captions
from llamagen_tpu_torch.cli.sample_c2i_fid import to_uint8
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.text.t5 import left_pad_embeddings


class T2ISamples(NamedTuple):
    results: List[dict]    # the rows of result.jsonl
    gen_seconds: float     # GPT sampling wall time (device synchronised)
    seconds: float         # the whole sampling loop


class RandomT5:
    """Prompt-hash-seeded embeddings: deterministic, T5-free."""

    def __init__(self, cls_token_num: int, cap_dim: int):
        self.cls_token_num = cls_token_num
        self.cap_dim = cap_dim

    def get_text_embeddings(self, texts):
        t = self.cls_token_num
        emb = np.zeros((len(texts), t, self.cap_dim), np.float32)
        mask = np.zeros((len(texts), t), np.int32)
        for i, s in enumerate(texts):
            # crc32, not hash(): str hashing is salted per process
            # (PYTHONHASHSEED), which would break run-to-run determinism
            r = np.random.RandomState(zlib.crc32(s.encode()))
            n = max(1, min(len(s.split()) + 2, t))
            emb[i, :n] = r.randn(n, self.cap_dim)
            mask[i, :n] = 1
        return emb, mask


class _T5Numpy:
    """The port's T5 encoder with numpy outputs (what the loop pads)."""

    def __init__(self, t5):
        self.t5 = t5

    def get_text_embeddings(self, texts):
        emb, mask = self.t5.get_text_embeddings(texts)
        return emb.float().cpu().numpy(), mask.cpu().numpy()


def main(argv=None) -> T2ISamples:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prompt-file", required=True,
                   help="tsv (PartiPrompts) / csv (coco) / jsonl / txt")
    p.add_argument("--gpt-model", default="GPT-XL")
    p.add_argument("--gpt-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--t5-path", default=None)
    p.add_argument("--random-t5", action="store_true",
                   help="deterministic random caption embeddings instead "
                        "of a T5 checkpoint (offline smoke/e2e runs)")
    p.add_argument("--cls-token-num", type=int, default=120)
    p.add_argument("--cfg-scale", type=float, default=7.5)
    p.add_argument("--top-k", type=int, default=1000)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--per-proc-batch-size", type=int, default=16)
    p.add_argument("--max-prompts", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-dir", default="samples_t2i")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    device = get_device(args.device)
    prompts = read_captions(args.prompt_file)
    if args.max_prompts > 0:
        prompts = prompts[:args.max_prompts]

    dtype = torch.bfloat16
    gpt = load_gpt(args.gpt_ckpt, args.gpt_model, args.image_size,
                   args.downsample_size, dtype, device, model_type="t2i",
                   cls_token_num=args.cls_token_num)
    vq_model = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                       args.codebook_embed_dim, dtype, device)
    latent = args.image_size // args.downsample_size

    if args.random_t5:
        t5 = RandomT5(args.cls_token_num, gpt.cfg.caption_dim)
    else:
        assert args.t5_path, ("--t5-path required (local flan-t5-xl "
                              "checkpoint), or use --random-t5")
        from llamagen_tpu_torch.text.t5 import T5TextEncoder
        t5 = _T5Numpy(T5TextEncoder(args.t5_path,
                                    model_max_length=args.cls_token_num,
                                    device=device))

    os.makedirs(args.sample_dir, exist_ok=True)
    results = []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    bs = args.per_proc_batch_size
    t0 = time.time()
    gen_seconds = 0.0
    for start in range(0, len(prompts), bs):
        batch_prompts = prompts[start:start + bs]
        pad = bs - len(batch_prompts)
        emb, mask = t5.get_text_embeddings(batch_prompts + [""] * pad)
        emb, mask = left_pad_embeddings(np.asarray(emb, np.float32),
                                        np.asarray(mask))
        t1 = time.time()
        seq = generate(gpt, torch.as_tensor(emb).to(device, dtype),
                       max_new_tokens=latent * latent,
                       emb_masks=torch.as_tensor(mask).to(device),
                       generator=generator, cfg_scale=args.cfg_scale,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, compute_dtype=dtype,
                       cache_dtype=dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gen_seconds += time.time() - t1
        imgs = to_uint8(vq_model.decode_code(seq.reshape(bs, latent,
                                                         latent)))
        for j, prompt in enumerate(batch_prompts):
            idx = start + j
            path = os.path.join(args.sample_dir, f"{idx:06d}.png")
            Image.fromarray(imgs[j]).save(path)
            results.append({"id": idx, "prompt": prompt, "image": path})
        print(f"{start + len(batch_prompts)}/{len(prompts)}", flush=True)
    seconds = time.time() - t0

    with open(os.path.join(args.sample_dir, "result.jsonl"), "w") as f:
        for row in results:
            f.write(json.dumps(row) + "\n")
    print(f"done: {len(results)} images in {args.sample_dir} "
          f"({len(results) / max(seconds, 1e-9):.3f} img/s; sampling "
          f"{gen_seconds:.3f} s)")
    return T2ISamples(results, gen_seconds, seconds)


if __name__ == "__main__":
    main()
