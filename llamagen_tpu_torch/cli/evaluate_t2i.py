"""t2i evaluation: CLIP score + FID over a result.jsonl of sampled images
(PyTorch port of `llamagen_tpu/cli/evaluate_t2i.py`).

Equivalent of upstream LlamaGen's `evaluations/t2i/evaluation.py`
(GigaGAN protocol): the CLIP ViT-B/32 cosine score and FID against a
reference image set (clean-fid there; here the ADM FID stack of
`llamagen_tpu_torch.eval`), on the card.

  python -m llamagen_tpu_torch.cli.evaluate_t2i \\
      --result samples_t2i/result.jsonl \\
      --clip-model-dir /weights/clip-vit-base-patch32 \\
      --ref-batch coco_val.npz --inception-weights pt_inception.pth

Both metrics are weights-gated: omit --clip-model-dir or --ref-batch to
skip the corresponding metric.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device


def load_result_jsonl(path: str, max_rows: int = -1):
    """result.jsonl rows {id, prompt, image} (cli.sample_t2i_fid output)."""
    from PIL import Image

    prompts, images = [], []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            prompts.append(row["prompt"])
            images.append(np.array(Image.open(row["image"]).convert("RGB")))
            if 0 < max_rows <= len(prompts):
                break
    return np.stack(images), prompts


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--result", required=True,
                   help="result.jsonl from cli.sample_t2i_fid")
    p.add_argument("--clip-model-dir", default=None,
                   help="local HF CLIP dir (ViT-B/32) for CLIP score")
    p.add_argument("--ref-batch", default=None,
                   help="reference npz/npy image batch for FID")
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-rows", type=int, default=-1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = get_device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # f32 features
    images, prompts = load_result_jsonl(args.result, args.max_rows)
    print(f"loaded {len(prompts)} (image, prompt) pairs")
    metrics: Dict[str, float] = {}

    if args.clip_model_dir:
        from llamagen_tpu_torch.eval.clip import ClipScorer

        scorer = ClipScorer(args.clip_model_dir, batch_size=args.batch_size,
                            device=device)
        metrics["CLIP score"] = scorer.score(images, prompts)
    else:
        print("no --clip-model-dir: skipping CLIP score")

    if args.ref_batch:
        from llamagen_tpu_torch.cli.evaluate import stream_npz
        from llamagen_tpu_torch.eval import inception
        from llamagen_tpu_torch.eval.fid import (activation_statistics,
                                                 frechet_distance)

        extractor = inception.FeatureExtractor(args.inception_weights,
                                               batch_size=args.batch_size,
                                               device=device)
        ref_pool, _, _ = extractor.features_from_batches(
            stream_npz(args.ref_batch, batch_size=args.batch_size))
        pool, _, _ = extractor.features(images)
        metrics["FID"] = frechet_distance(*activation_statistics(ref_pool),
                                          *activation_statistics(pool))
    else:
        print("no --ref-batch: skipping FID")

    lines = [f"{name}: {value:.5f}" for name, value in metrics.items()]
    print("\n".join(lines) if lines else "nothing to compute")
    if lines:
        txt = os.path.splitext(args.result)[0] + "_eval.txt"
        with open(txt, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {txt}")
    return metrics


if __name__ == "__main__":
    main()
