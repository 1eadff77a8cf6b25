"""Build and load the port's CUDA kernels.

Every `llamagen_tpu_torch/csrc/*.cu` file is compiled by `nvcc` (one
process per file, in parallel) and linked into ONE shared library with a
plain C interface, at first use, into `.build/` at the repository root
(git-ignored). The library's name carries a hash of
the sources, so an edited source builds anew and a stale library is never
loaded. The library is bound with `ctypes`: each C entry point takes raw
device pointers and the CUDA stream as `void*` and returns `cudaError_t`.

Nothing is compiled when this module is imported, only when a wrapper on
a CUDA tensor first asks for the library. A missing `nvcc` or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "llamagen_tpu_torch cannot be built")
    return nvcc


def build() -> Path:
    """Compile the sources unless the library for their hash exists.

    Each `.cu` file is compiled to an object by its own `nvcc`, all started
    together, then the objects are linked into the library. The compilers'
    output (`-Xptxas -v`: registers, shared memory and spills per kernel)
    is kept beside the library as `<name>.log`. A file lock makes the
    processes of one machine (the ranks of a training run) build once.
    """
    out = BUILD_DIR / f"libllamagen_kernels_{_source_hash(_sources())}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # ranks of one machine build once: the first takes the lock and
    # builds, the others wait for it and find the library
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, jobs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            objs.append(str(Path(tmp) / f"{src.stem}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compiler before raising: none is left running
        logs = [(proc, f"$ {' '.join(cmd)}\n{proc.communicate()[0]}")
                for cmd, proc in jobs]
        for proc, text in logs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
        # link under a temporary name and rename: a concurrent or
        # interrupted build never leaves a half-written library in place
        lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text("\n".join(t for _, t in logs))
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call (cached per process)."""
    return ctypes.CDLL(str(build()))


@functools.lru_cache(maxsize=None)
def c_function(name: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """Bind `cudaError_t name(void* x n_pointers, int x n_ints,
    float x n_floats, void* stream)` from the library."""
    fn = getattr(load_library(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The device's SM count (the kernels' launch geometry), asked once."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
