"""Shared CLI helpers: device choice, the trainers' process group,
checkpoint loading, image saving."""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from llamagen_tpu_torch.config import gpt_config, vq_config
from llamagen_tpu_torch.models import gpt as gpt_lib
from llamagen_tpu_torch.models import vq as vq_lib
from llamagen_tpu_torch.parallel import distributed
from llamagen_tpu_torch.parallel import mesh as mesh_lib
from llamagen_tpu_torch.utils.convert import (load_torch_state_dict,
                                              strip_prefixes)


def get_device(name: str) -> torch.device:
    """The requested device; `cuda` without a GPU raises (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    return device


def add_parallel_args(p, dp: int = 1, fsdp: Optional[int] = -1) -> None:
    """--dp / --fsdp / --tp (JAX's mesh flags; -1 absorbs the world);
    `fsdp` None leaves --fsdp out (the VQ-GAN CLI)."""
    p.add_argument("--dp", type=int, default=dp,
                   help="data-parallel (DDP) ranks; -1: the rest")
    if fsdp is not None:
        p.add_argument("--fsdp", type=int, default=fsdp,
                       help="fully sharded (FSDP2) ranks; -1: the rest")
        p.add_argument("--tp", type=int, default=1,
                       help="tensor parallel: only 1 (ROADMAP item 9)")


@contextlib.contextmanager
def process_group(args, device: torch.device
                  ) -> Iterator[Tuple[torch.device, Optional[DeviceMesh]]]:
    """(this rank's device, the ("dp", "fsdp") mesh) of a training CLI.

    Under torchrun (or a multi-task SLURM job) the process group is made,
    even at one rank, and torn down at exit if this call made it; a plain
    run is one process with no mesh, and a mesh other than 1 x 1 raises
    `ValueError` there. `--tp` above 1 raises `NotImplementedError`."""
    dp, fsdp, tp = args.dp, getattr(args, "fsdp", 1), getattr(args, "tp", 1)
    owned = not dist.is_initialized()
    if not distributed.init_distributed(device.type):
        mesh_lib.mesh_shape(dp, fsdp, tp, 1)
        yield device, None
        return
    try:
        device = distributed.local_device(device)
        yield device, mesh_lib.make_mesh(dp, fsdp, tp, device.type)
        if owned:
            dist.barrier()
    finally:
        if owned:
            dist.destroy_process_group()


def min_over_ranks(value: int, device: torch.device) -> int:
    """The least of the ranks' `value`s: the step bound that ranks whose
    data differ in size stop at together, or 0 where any rank says no;
    one process: `value`."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _load(path: str, keep_dtypes: bool = False) -> Dict[str, torch.Tensor]:
    """A released `.pt` (trainer wrappers and `module.` prefixes removed)."""
    return strip_prefixes(load_torch_state_dict(path, keep_dtypes))


def _load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:8]}")


def shape_quantized_linears(model: gpt_lib.Transformer,
                             sd: Dict[str, torch.Tensor]) -> None:
    """Each `Linear` whose checkpoint entry is quantised (W8A16 `weight_q` /
    `weight_scale` or W4 `weight_w4b` / `weight_w4s`, as `cli/tools.py
    quantize-ckpt` writes them) gets buffers of the stored shapes and
    dtypes in place of its `weight`, which `load_state_dict` then fills."""
    for name, mod in model.named_modules():
        if not isinstance(mod, gpt_lib.Linear):
            continue
        keys = [k for k in mod.QUANT_KEYS if f"{name}.{k}" in sd]
        if keys:
            dev = mod.weight.device
            mod.weight = None
            for k in keys:
                setattr(mod, k, torch.empty_like(sd[f"{name}.{k}"],
                                                 device=dev))


def load_gpt(gpt_ckpt: Optional[str], gpt_model: str, image_size: int,
             downsample_size: int, dtype: torch.dtype,
             device: torch.device, model_type: str = "c2i",
             cls_token_num: Optional[int] = None) -> gpt_lib.Transformer:
    """c2i or t2i GPT from a `.pt` state dict (bf16/f32, or W8A16 / W4
    quantised), or seeded random weights (the reference init, zero head)
    when `gpt_ckpt` is None. cls_token_num defaults to 1 (c2i) or 120
    (t2i), as in JAX `cli/common.py`."""
    latent = image_size // downsample_size
    if cls_token_num is None:
        cls_token_num = 1 if model_type == "c2i" else 120
    cfg = gpt_config(gpt_model, block_size=latent * latent,
                     cls_token_num=cls_token_num, model_type=model_type)
    model = gpt_lib.Transformer(cfg, device=device, dtype=dtype)
    if gpt_ckpt is None:
        gpt_lib.init_weights(model, seed=0)
    else:
        sd = _load(gpt_ckpt, keep_dtypes=True)
        shape_quantized_linears(model, sd)
        _load_into(model, sd)
    return model.eval()


def load_vq(vq_ckpt: Optional[str], vq_model: str, codebook_size: int,
            codebook_embed_dim: int, dtype: torch.dtype,
            device: torch.device, encoder: bool = False) -> vq_lib.VQModel:
    """VQ tokenizer from a `.pt` state dict, or seeded random weights: the
    decode half (what the sampling CLIs need; a decode-only checkpoint
    loads), or with `encoder` the whole model."""
    cfg = vq_config(vq_model, codebook_size=codebook_size,
                    codebook_embed_dim=codebook_embed_dim)
    model = vq_lib.VQModel(cfg, device=device, dtype=dtype, encoder=encoder)
    if vq_ckpt is None:
        vq_lib.init_weights(model, seed=0)
    else:
        sd = _load(vq_ckpt)
        _load_into(model, sd if encoder else vq_lib.decode_half(sd))
    return model.eval()


def _png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (zlib only, no imaging library)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 4,
                    padding: int = 2) -> None:
    """images: [N, H, W, 3] in [-1, 1] -> grid png (torchvision-style)."""
    imgs = np.clip((np.asarray(images, np.float32) + 1) * 127.5, 0, 255
                   ).astype(np.uint8)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.full(((h + padding) * nrows - padding,
                    (w + padding) * ncol - padding, c), 255, np.uint8)
    for i, img in enumerate(imgs):
        r, cc = divmod(i, ncol)
        grid[r * (h + padding):r * (h + padding) + h,
             cc * (w + padding):cc * (w + padding) + w] = img
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_png(grid))
