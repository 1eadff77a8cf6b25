"""ctypes bindings for the native C++ shard loader (native/dataloader.cc).

The port's own copy of `llamagen_tpu/data/native.py`. It builds the
repository's `native/dataloader.cc` with `g++ -O3 -shared` on first use,
into `.build/` at the repository root (git-ignored, where the CUDA kernels
go too), so it never touches the JAX package's build of the same source.
A missing toolchain raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "dataloader.cc")
_LIB = os.path.join(_REPO_ROOT, ".build", "libdataloader.so")

RAW_MAGIC = 0x4C47434E


def _build_lib() -> str:
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp])
        os.replace(tmp, _LIB)  # never a half-written library in place
    return _LIB


def _load():
    lib = ctypes.CDLL(_build_lib())
    lib.lg_open.restype = ctypes.c_void_p
    lib.lg_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_long, ctypes.c_int]
    lib.lg_seq_len.restype = ctypes.c_int
    lib.lg_seq_len.argtypes = [ctypes.c_void_p]
    lib.lg_num_samples.restype = ctypes.c_long
    lib.lg_num_samples.argtypes = [ctypes.c_void_p]
    lib.lg_next.restype = ctypes.c_int
    lib.lg_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.lg_close.argtypes = [ctypes.c_void_p]
    return lib


def write_raw_shard(path: str, codes: np.ndarray, labels: np.ndarray) -> None:
    """Write one raw shard: codes [N, L] int16, labels [N] int16."""
    n, seq_len = codes.shape
    header = np.zeros(6, np.uint32)
    header[0] = RAW_MAGIC
    header[1] = 1
    header[2] = n & 0xFFFFFFFF
    header[3] = (n >> 32) & 0xFFFFFFFF
    header[4] = seq_len
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(codes, np.int16).tobytes())
        f.write(np.ascontiguousarray(labels, np.int16).tobytes())


def pack_shards_raw(dataset, out_dir: str, shard_size: int = 250_000) -> int:
    """Repack any (codes, label) dataset into raw shards for the C++ loader."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    num_shards = 0
    for start in range(0, n, shard_size):
        end = min(start + shard_size, n)
        first, _ = dataset[start]
        L = first.reshape(-1).shape[0]
        codes = np.zeros((end - start, L), np.int16)
        labels = np.zeros((end - start,), np.int16)
        for i in range(start, end):
            c, lab = dataset[i]
            codes[i - start] = c.reshape(-1)[:L]
            labels[i - start] = lab
        write_raw_shard(
            os.path.join(out_dir, f"shard_{num_shards:05d}.codes"),
            codes, labels)
        num_shards += 1
    return num_shards


class NativeCodeLoader:
    """Background-threaded shuffled batch stream from raw shards."""

    def __init__(self, shard_dir: str, batch_size: int, seed: int = 0,
                 queue_depth: int = 4, *, num_hosts: int = 1,
                 host_id: int = 0):
        """batch_size is per-host; with num_hosts > 1 each host strides a
        disjoint subset of the shard files (shard-level data parallelism —
        pack with shard_size small enough that #shards >= #hosts)."""
        self._lib = _load()
        paths = sorted(
            os.path.join(shard_dir, f) for f in os.listdir(shard_dir)
            if f.endswith(".codes"))
        assert paths, f"no .codes shards in {shard_dir}"
        if num_hosts > 1:
            assert len(paths) >= num_hosts, (
                f"{len(paths)} shards < {num_hosts} hosts: repack with a "
                f"smaller shard_size for shard-level host striding")
            paths = paths[host_id::num_hosts]
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._h = self._lib.lg_open(arr, len(paths), batch_size, seed,
                                    queue_depth)
        if not self._h:
            raise RuntimeError(f"failed to open shards in {shard_dir}")
        self.batch_size = batch_size
        self.seq_len = self._lib.lg_seq_len(self._h)
        self.num_samples = self._lib.lg_num_samples(self._h)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        codes = np.empty((self.batch_size, self.seq_len), np.int32)
        labels = np.empty((self.batch_size,), np.int32)
        ok = self._lib.lg_next(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not ok:
            raise StopIteration
        return codes, labels

    def close(self):
        if self._h:
            self._lib.lg_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
