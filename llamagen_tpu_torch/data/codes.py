"""Datasets of pre-extracted VQ codes for GPT training.

The port's own copy of `llamagen_tpu/data/codes.py` (numpy only). Upstream
LlamaGen trains from 1.28M per-sample `.npy` micro-files (`{i}.npy` code
arrays of shape [1, num_aug, L] + label files); this module reads both
that layout and packed shards:

  - `NpyCodeDataset`: upstream-layout reader (drop-in for converted dumps)
  - packed single-file shards (`pack_shards` / `PackedCodeDataset`):
    [N, num_aug, L] int16 memmap + [N] labels — sequential reads, no
    per-sample open() syscalls, trivially shardable across hosts.

Batches are host-side numpy; the training CLI moves them to the device
(`cli/train_c2i.py`).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


class NpyCodeDataset:
    """Reference-layout reader: dir with {i}.npy codes and labels.

    Ref: dataset/imagenet.py — feature dir `{code_path}/imagenet{size}_codes`,
    label dir `{code_path}/imagenet{size}_labels`.
    """

    def __init__(self, feature_dir: str, label_dir: str, *, seed: int = 0):
        self.feature_dir = feature_dir
        self.label_dir = label_dir
        self.num = len([f for f in os.listdir(feature_dir) if f.endswith(".npy")])
        # Own RNG stream (seeded): the aug pick must not depend on the global
        # numpy RNG so runs are reproducible per (seed, access order) — every
        # other data path in this repo is deterministically seeded.
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.num

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        codes = np.load(os.path.join(self.feature_dir, f"{idx}.npy"))
        labels = np.load(os.path.join(self.label_dir, f"{idx}.npy"))
        # pick one augmentation (ref: dataset/imagenet.py random aug choice)
        aug = self._rng.randint(codes.shape[1]) if codes.ndim == 3 else 0
        code = codes[0, aug] if codes.ndim == 3 else codes.reshape(-1)
        return code.astype(np.int32), labels.reshape(-1)[0].astype(np.int32)


def pack_shards(dataset, out_dir: str, shard_size: int = 100_000,
                seq_len: Optional[int] = None) -> int:
    """Repack any (codes, label) dataset into flat memmap-able shards.

    Writes uncompressed `.npy` pairs (`shard_XXXXX.codes.npy` /
    `shard_XXXXX.labels.npy`): unlike zipped `.npz` members these really do
    memory-map with `np.load(mmap_mode="r")`, so t2i-scale datasets never
    materialize in host RAM.
    """
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    num_shards = 0
    for start in range(0, n, shard_size):
        end = min(start + shard_size, n)
        first_code, _ = dataset[start]
        L = seq_len or first_code.shape[-1]
        codes = np.zeros((end - start, L), np.int16)
        labels = np.zeros((end - start,), np.int16)
        for i in range(start, end):
            c, lab = dataset[i]
            codes[i - start] = c.reshape(-1)[:L]
            labels[i - start] = lab
        stem = os.path.join(out_dir, f"shard_{num_shards:05d}")
        np.save(stem + ".codes.npy", codes)
        np.save(stem + ".labels.npy", labels)
        num_shards += 1
    return num_shards


class PackedCodeDataset:
    """Reads packed shards as per-shard memmaps (no RAM materialization).

    Accepts `.codes.npy`/`.labels.npy` pairs (memory-mapped; preferred) or
    legacy `.npz` shards (zip members cannot be mmapped — those load into
    RAM, acceptable only for ImageNet-c2i-scale code dumps, ~1.5 GB).

    `num_hosts`/`host_id` stride samples across hosts for multi-host
    training (each host sees a disjoint deterministic subset per epoch),
    the TPU analogue of the reference's DistributedSampler rank striding.
    """

    def __init__(self, shard_dir: str, *, num_hosts: int = 1,
                 host_id: int = 0):
        npy = sorted(f for f in os.listdir(shard_dir)
                     if f.endswith(".codes.npy"))
        npz = sorted(f for f in os.listdir(shard_dir) if f.endswith(".npz"))
        self._codes, self._labels = [], []
        if npy:
            for f in npy:
                stem = os.path.join(shard_dir, f[:-len(".codes.npy")])
                self._codes.append(np.load(stem + ".codes.npy",
                                           mmap_mode="r"))
                self._labels.append(np.load(stem + ".labels.npy",
                                            mmap_mode="r"))
        elif npz:
            for f in npz:
                z = np.load(os.path.join(shard_dir, f))
                self._codes.append(z["codes"])
                self._labels.append(z["labels"])
        else:
            raise FileNotFoundError(f"no packed shards in {shard_dir}")
        self._offsets = np.cumsum([0] + [c.shape[0] for c in self._codes])
        assert 0 <= host_id < num_hosts
        self.num_hosts = num_hosts
        self.host_id = host_id

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _gather(self, sel: np.ndarray,
                rng: Optional[np.random.RandomState] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        shard = np.searchsorted(self._offsets, sel, side="right") - 1
        local = sel - self._offsets[shard]
        codes = np.empty((len(sel), self._codes[0].shape[-1]), np.int32)
        labels = np.empty((len(sel),), np.int32)
        for s in np.unique(shard):
            m = shard == s
            picked = self._codes[s][local[m]]
            if picked.ndim == 3:
                # augmented shard [N, naug, L] (extract_codes --flip-aug /
                # --ten-crop): draw one augmentation per sample per access,
                # the reference's convention (dataset/imagenet.py:33-38
                # torch.randint over the aug axis). rng=None (no shuffle
                # rng supplied) deterministically takes aug 0.
                k, naug, _ = picked.shape
                ai = (rng.randint(0, naug, k) if rng is not None
                      else np.zeros(k, np.int64))
                picked = picked[np.arange(k), ai]
            codes[m] = picked
            labels[m] = self._labels[s][local[m]]
        return codes, labels

    def batches(self, batch_size: int, *, seed: int = 0, epochs: int = -1,
                drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite (or epochs-bounded) shuffled batch iterator.

        batch_size is the PER-HOST batch; with num_hosts > 1, every host
        permutes identically (same seed) and takes its host_id stride.
        """
        n = len(self)
        epoch = 0
        while epochs < 0 or epoch < epochs:
            rng = np.random.RandomState(seed + epoch)
            order = rng.permutation(n)
            # every host gets as many rows (and batches): hosts step alike
            order = order[:n - n % self.num_hosts]
            order = order[self.host_id::self.num_hosts]
            hn = len(order)
            for start in range(0, hn - (batch_size - 1 if drop_remainder else 0),
                               batch_size):
                sel = order[start:start + batch_size]
                if len(sel) < batch_size and drop_remainder:
                    break
                yield self._gather(sel, rng)
            epoch += 1


class SyntheticCodeDataset:
    """Random codes/labels for smoke tests and benchmarks."""

    def __init__(self, num: int, seq_len: int, vocab_size: int = 16384,
                 num_classes: int = 1000, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.codes = rng.randint(0, vocab_size, size=(num, seq_len)).astype(np.int16)
        self.labels = rng.randint(0, num_classes, size=(num,)).astype(np.int16)

    def __len__(self):
        return self.codes.shape[0]

    def __getitem__(self, idx):
        return self.codes[idx].astype(np.int32), self.labels[idx].astype(np.int32)

    def batches(self, batch_size: int, *, seed: int = 0, epochs: int = -1,
                drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self)
        epoch = 0
        while epochs < 0 or epoch < epochs:
            order = np.random.RandomState(seed + epoch).permutation(n)
            for start in range(0, n - (batch_size - 1 if drop_remainder else 0),
                               batch_size):
                sel = order[start:start + batch_size]
                yield (self.codes[sel].astype(np.int32),
                       self.labels[sel].astype(np.int32))
            epoch += 1
