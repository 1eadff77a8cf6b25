"""ADM-suite evaluation front-end: FID / sFID / IS / Precision / Recall
(PyTorch port of `llamagen_tpu/cli/evaluate.py`).

Equivalent of upstream LlamaGen's `evaluations/c2i/evaluator.py`:

  python -m llamagen_tpu_torch.cli.evaluate ref_batch.npz sample_batch.npy \\
      --inception-weights pt_inception-2015-12-05-6726825d.pth

Reads image batches (`arr_0` uint8 [N, H, W, 3] of an `.npz`, or a bare
`.npy` as `cli/sample_c2i_fid.py` writes it) in streamed chunks, extracts
Inception pool3 / spatial / logits features on the card
(`eval/inception.py`, f32 with TF32 off) and reports the metric panel.
Writes a `.txt` next to the sample batch, as the reference does.
"""

from __future__ import annotations

import argparse
import os
import time
import zipfile
from typing import Dict, NamedTuple

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import get_device
from llamagen_tpu_torch.eval.fid import (activation_statistics,
                                         frechet_distance, inception_score,
                                         precision_recall)


class EvalResult(NamedTuple):
    metrics: Dict[str, float]   # the five metrics, in the printed order
    seconds: Dict[str, float]   # wall time of each part


def stream_npz(path: str, key: str = "arr_0", batch_size: int = 64):
    """Yield [b, H, W, 3] batches from an npz member without materializing
    the whole (often ~10 GB for 50k samples) array in RAM.

    Reads the zip member as a stream: npy header first, then row-aligned
    chunks (mirrors the reference evaluator's batched reads). Works for
    both compressed and stored members. Bare `.npy` files
    (`cli/sample_c2i_fid.py`'s output) are memory-mapped and sliced.
    """
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        for start in range(0, arr.shape[0], batch_size):
            yield np.asarray(arr[start:start + batch_size])
        return
    with zipfile.ZipFile(path) as zf:
        name = key if key in zf.namelist() else key + ".npy"
        with zf.open(name) as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            assert not fortran, "fortran-order npz not supported"
            n = int(shape[0])
            row_bytes = int(np.prod(shape[1:])) * dtype.itemsize
            for start in range(0, n, batch_size):
                m = min(batch_size, n - start)
                buf = f.read(row_bytes * m)
                yield np.frombuffer(buf, dtype).reshape((m,) + shape[1:])


def metric_panel(ref_pool: np.ndarray, ref_spatial: np.ndarray,
                 pool: np.ndarray, spatial: np.ndarray,
                 logits: np.ndarray) -> Dict[str, float]:
    """The five metrics from the reference and sample features."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    prec, recall = precision_recall(ref_pool, pool)
    return {
        "Inception Score": inception_score(probs),
        "FID": frechet_distance(*activation_statistics(ref_pool),
                                *activation_statistics(pool)),
        "sFID": frechet_distance(*activation_statistics(ref_spatial),
                                 *activation_statistics(spatial)),
        "Precision": prec,
        "Recall": recall,
    }


def main(argv=None) -> EvalResult:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ref_batch")
    p.add_argument("sample_batch")
    p.add_argument("--inception-weights", default=None,
                   help="pytorch-fid InceptionV3 state dict (.pth)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from llamagen_tpu_torch.eval import inception

    device = get_device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # f32 features
    extractor = inception.FeatureExtractor(args.inception_weights,
                                           batch_size=args.batch_size,
                                           device=device)

    t0 = time.time()
    print("computing reference batch activations...")
    ref_pool, ref_spatial, _ = extractor.features_from_batches(
        stream_npz(args.ref_batch, batch_size=args.batch_size))
    t1 = time.time()
    print("computing sample batch activations...")
    pool, spatial, logits = extractor.features_from_batches(
        stream_npz(args.sample_batch, batch_size=args.batch_size))
    t2 = time.time()
    metrics = metric_panel(ref_pool, ref_spatial, pool, spatial, logits)
    seconds = {"reference features": t1 - t0, "sample features": t2 - t1,
               "metrics": time.time() - t2}
    print("seconds: " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in seconds.items()))

    lines = [f"{name}: {value:.5f}" for name, value in metrics.items()]
    print("\n".join(lines))
    # splitext, not .replace(".npz", ...): on a .npy sample batch the
    # replace is a no-op and open("w") would truncate the batch itself
    txt_path = os.path.splitext(args.sample_batch)[0] + ".txt"
    with open(txt_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {txt_path}")
    return EvalResult(metrics, seconds)


if __name__ == "__main__":
    main()
