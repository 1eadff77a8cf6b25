"""Offline T5 caption-feature extraction (PyTorch port).

Same flags and output as `llamagen_tpu/cli/extract_t5_features.py`, plus
`--device`: encodes the captions of a jsonl / tsv / txt file with a local
flan-t5-xl directory and writes one `<index>.npz` per caption (`feature`
[T, 2048] f16, `mask` [T] i8) for t2i training.

  python -m llamagen_tpu_torch.cli.extract_t5_features \
      --caption-file caps.jsonl --t5-path /path/to/flan-t5-xl \
      --out-dir /data/t5_feat
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from llamagen_tpu_torch.cli.common import get_device


def read_captions(path: str):
    caps = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                caps.append(row.get("caption") or row.get("text"))
    elif path.endswith(".tsv"):
        with open(path) as f:
            next(f)  # header
            for line in f:
                caps.append(line.split("\t")[0])
    else:
        with open(path) as f:
            caps = [line.strip() for line in f if line.strip()]
    return caps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--caption-file", required=True)
    p.add_argument("--t5-path", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model-max-length", type=int, default=120)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=-1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from llamagen_tpu_torch.text.t5 import T5TextEncoder

    caps = read_captions(args.caption_file)
    if args.end > 0:
        caps = caps[args.start:args.end]
    else:
        caps = caps[args.start:]

    t5 = T5TextEncoder(args.t5_path, model_max_length=args.model_max_length,
                       device=get_device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(0, len(caps), args.batch_size):
        batch = caps[i:i + args.batch_size]
        emb, mask = t5.get_text_embeddings(batch)
        emb = emb.float().cpu().numpy().astype(np.float16)
        mask = mask.cpu().numpy().astype(np.int8)
        for j in range(len(batch)):
            idx = args.start + i + j
            np.savez(os.path.join(args.out_dir, f"{idx}.npz"),
                     feature=emb[j], mask=mask[j])
        if (i // args.batch_size) % 50 == 0:
            print(f"{i + len(batch)}/{len(caps)}", flush=True)
    print(f"done: {len(caps)} captions -> {args.out_dir}")


if __name__ == "__main__":
    main()
