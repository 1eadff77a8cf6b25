"""Hub-layout model directories: `config.json` + `model.safetensors`.

Counterpart of `llamagen_tpu/utils/hub.py` (upstream's
`PyTorchModelHubMixin` wrappers, `vq_model_hf.py` and `gpt_hf.py`). A
directory holds `config.json`, the config dataclass's fields under the
names the JAX package writes plus `model_kind` ("gpt" or "vq"), and
`model.safetensors`, the port's state dict (upstream keys; bf16, int8 and
W4 tensors keep their dtypes). `save_pretrained` and `load_pretrained`
work on local directories; `push_to_hub` and loading a hub repo id need
`huggingface_hub`, credentials and network access, and are imported only
when called.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple, Union

import torch

from llamagen_tpu_torch.config import GPTConfig, VQConfig

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "model.safetensors"

Config = Union[GPTConfig, VQConfig]


def save_pretrained(save_dir: str, state_dict: Dict[str, torch.Tensor],
                    config: Config, *, model_kind: str) -> str:
    """Write `save_dir`/config.json and model.safetensors; returns the
    directory."""
    from safetensors.torch import save_file

    if model_kind not in ("gpt", "vq"):
        raise ValueError(f"model_kind {model_kind!r}: gpt or vq")
    os.makedirs(save_dir, exist_ok=True)
    cfg = dataclasses.asdict(config)
    cfg["model_kind"] = model_kind
    with open(os.path.join(save_dir, CONFIG_NAME), "w") as f:
        json.dump(cfg, f, indent=2)
    save_file({k: v.detach().cpu().contiguous()
               for k, v in state_dict.items()},
              os.path.join(save_dir, WEIGHTS_NAME))
    return save_dir


def load_pretrained(repo_or_dir: str, *,
                    dtype: Optional[torch.dtype] = None,
                    revision: Optional[str] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Config]:
    """(state dict of CPU tensors, config) from a local directory, or from
    a hub repo id through `snapshot_download`. `dtype` casts the floating
    tensors; int8 levels stay int8."""
    from safetensors.torch import load_file

    path = repo_or_dir
    if not os.path.isdir(path):
        from huggingface_hub import snapshot_download
        path = snapshot_download(repo_or_dir, revision=revision)
    with open(os.path.join(path, CONFIG_NAME)) as f:
        raw = json.load(f)
    cls = GPTConfig if raw.pop("model_kind") == "gpt" else VQConfig
    fields = {f.name for f in dataclasses.fields(cls)}
    config = cls(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in raw.items() if k in fields})
    sd = load_file(os.path.join(path, WEIGHTS_NAME))
    if dtype is not None:
        sd = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in sd.items()}
    return sd, config


def push_to_hub(save_dir: str, repo_id: str, *, private: bool = True,
                token: Optional[str] = None) -> str:
    """Upload a saved directory (needs credentials and network access)."""
    from huggingface_hub import HfApi

    api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=save_dir, repo_id=repo_id)
    return f"https://huggingface.co/{repo_id}"
