"""t2i training data: images paired with precomputed T5 caption features
(the port's copy of `llamagen_tpu/data/t2i.py`).

Items are (image [H, W, 3] f32 in [-1, 1], T5 features [T, C] f32,
caption mask [T] int32, valid flag f32). An unreadable image or feature
file is replaced by a random other item up to `retries` times, then by a
dummy with valid 0, so that the loss can mask it (upstream
`dataset/t2i.py`, `dataset/openimage.py`).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np

Item = Tuple[np.ndarray, np.ndarray, np.ndarray, np.float32]


class T2IDataset:
    """A jsonl of {image_path, caption_idx?} rows paired with a directory
    of T5 features `{caption_idx}.npz` (`feature` [T, C], `mask` [T], as
    `cli/extract_t5_features.py` writes them)."""

    def __init__(self, jsonl_path: str, feature_dir: str, image_size: int,
                 caption_dim: int = 2048, t5_len: int = 120,
                 left_pad: bool = True, retries: int = 0):
        self.items = []
        with open(jsonl_path) as f:
            for i, line in enumerate(f):
                row = json.loads(line)
                self.items.append(
                    (row.get("image_path") or row.get("image"),
                     int(row.get("caption_idx", i))))
        self.feature_dir = feature_dir
        self.image_size = image_size
        self.caption_dim = caption_dim
        self.t5_len = t5_len
        self.left_pad = left_pad
        self.retries = retries

    def __len__(self) -> int:
        return len(self.items)

    def _dummy(self) -> Item:
        """A bad sample's placeholder, valid 0; the last caption position
        stays valid, so that attention has a key."""
        img = np.zeros((self.image_size, self.image_size, 3), np.float32)
        feat = np.zeros((self.t5_len, self.caption_dim), np.float32)
        mask = np.zeros((self.t5_len,), np.int32)
        mask[-1] = 1
        return img, feat, mask, np.float32(0.0)

    def __getitem__(self, idx: int) -> Item:
        item = self._load(idx)
        rng: Optional[np.random.RandomState] = None
        for _ in range(self.retries):
            if item is not None:
                break
            rng = rng or np.random.RandomState(idx)
            item = self._load(rng.randint(len(self.items)))
        return item if item is not None else self._dummy()

    def _load(self, idx: int) -> Optional[Item]:
        """One sample, or None when a file is unreadable."""
        from PIL import Image

        from llamagen_tpu_torch.cli.extract_codes import center_crop
        from llamagen_tpu_torch.text.t5 import left_pad_embeddings

        path, cap_idx = self.items[idx]
        feat_path = os.path.join(self.feature_dir, f"{cap_idx}.npz")
        try:
            img = Image.open(path).convert("RGB")
            arr = center_crop(img, self.image_size).astype(np.float32)
            arr = arr / 127.5 - 1.0
            with np.load(feat_path) as z:
                feat = z["feature"].astype(np.float32)
                mask = z["mask"].astype(np.int32)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            # unreadable or missing files, truncated or corrupt .npz
            # members: the retry / dummy path, not the end of a run
            return None

        t = self.t5_len
        if feat.shape[0] < t:
            feat = np.pad(feat, ((0, t - feat.shape[0]), (0, 0)))
            mask = np.pad(mask, (0, t - mask.shape[0]))
        feat, mask = feat[:t], mask[:t]
        if self.left_pad:
            feat, mask = left_pad_embeddings(feat[None], mask[None])
            feat, mask = feat[0], mask[0]
        return arr, feat, mask, np.float32(1.0)

    def batches(self, batch_size: int, seed: int = 0, epochs: int = -1,
                num_hosts: int = 1, host_id: int = 0
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """(images, features, masks, valid) batches of `batch_size` (per
        host): every host permutes alike (one seed per epoch) and takes its
        `host_id` stride, so hosts cover disjoint items."""
        n = len(self)
        epoch = 0
        while epochs < 0 or epoch < epochs:
            order = np.random.RandomState(seed + epoch).permutation(n)
            # every host gets as many rows (and batches): hosts step alike
            order = order[:n - n % num_hosts][host_id::num_hosts]
            for start in range(0, len(order) - batch_size + 1, batch_size):
                rows = [self[i] for i in order[start:start + batch_size]]
                imgs, feats, masks, valids = zip(*rows)
                yield (np.stack(imgs), np.stack(feats), np.stack(masks),
                       np.stack(valids))
            epoch += 1
