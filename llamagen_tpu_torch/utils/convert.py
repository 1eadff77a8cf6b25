"""Checkpoint loading, and JAX parameter trees -> port state dicts
(upstream LlamaGen keys).

`load_torch_state_dict` reads a `.pt` checkpoint (the port's copy of the
JAX package's loader, `llamagen_tpu/utils/convert.py`).

`gpt_state_dict_from_jax` and `vq_state_dict_from_jax` are the inverses
of that module's `convert_gpt` and `convert_vq`: per-layer tensors are
unstacked from `[L, ...]`, `[in, out]` kernels go back to `[out, in]`,
HWIO convolutions back to OIHW, and dense
`[I, O]` kernels that upstream stores as 1x1 convolutions back to
`[O, I, 1, 1]`. Inputs are numpy arrays (`jax.tree.map(np.asarray, p)`);
outputs are dicts of CPU torch tensors for `load_state_dict`.
`t5_state_dict_from_flax` carries HF Flax T5 encoder weights (what the
JAX package's `text/t5.py` runs) into the port's `text/t5.py::T5Encoder`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from llamagen_tpu_torch.config import GPTConfig, VQConfig

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str, keep_dtypes: bool = False) -> StateDict:
    """A `.pt` checkpoint -> {name: CPU tensor}, unwrapping trainer dicts
    (`model`, `module`, `state_dict`, `ema`).

    By default every tensor comes back f32, as the JAX package's loader
    gives it. `keep_dtypes` keeps each tensor's stored dtype: quantised
    checkpoints (`cli/tools.py quantize-ckpt`) hold int8 W8A16 weights and
    nibble-packed W4 blocks, which an upcast would corrupt.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "module", "state_dict", "ema"):
        if isinstance(ckpt, dict) and key in ckpt \
                and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
            break
    return {k: v.detach().cpu() if keep_dtypes
            else v.detach().to(torch.float32).cpu()
            for k, v in ckpt.items() if torch.is_tensor(v)}


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def gpt_state_dict_from_jax(params: Mapping[str, Any],
                            cfg: GPTConfig) -> StateDict:
    """JAX `models.gpt` params (numpy) -> port `Transformer` state dict
    (c2i: the class table; t2i: the caption MLP and `uncond_embedding`,
    JAX `utils/convert.py:195-203` inverted)."""
    layers = params["layers"]
    cls = params["cls_embedding"]
    sd = {"tok_embeddings.weight": _t(params["tok_embeddings"]),
          "norm.weight": _t(params["norm"]),
          "output.weight": _t(np.asarray(params["output"]).T)}
    if cfg.model_type == "c2i":
        sd["cls_embedding.embedding_table.weight"] = \
            _t(cls["embedding_table"])
    else:
        for fc in ("fc1", "fc2"):
            sd[f"cls_embedding.cap_proj.{fc}.weight"] = \
                _t(np.asarray(cls[fc]["kernel"]).T)
        sd["cls_embedding.uncond_embedding"] = _t(cls["uncond_embedding"])
    linear = {"wqkv": "attention.wqkv", "wo": "attention.wo",
              "w1": "feed_forward.w1", "w2": "feed_forward.w2",
              "w3": "feed_forward.w3"}
    for i in range(cfg.n_layer):
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"layers.{i}.{norm}.weight"] = _t(layers[norm][i])
        for key, name in linear.items():
            sd[f"layers.{i}.{name}.weight"] = _t(np.asarray(layers[key][i]).T)
    return sd


def t5_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """HF `FlaxT5EncoderModel` params (numpy) -> the port `T5Encoder`
    state dict (HF's torch keys; Dense kernels `[in, out]` transposed)."""
    sd = {"shared.weight": _t(params["shared"]["embedding"])}
    enc = params["encoder"]
    for i, block in sorted(enc["block"].items(), key=lambda kv: int(kv[0])):
        attn, ff = block["layer"]["0"], block["layer"]["1"]
        base = f"encoder.block.{i}.layer"
        for key in ("q", "k", "v", "o"):
            sd[f"{base}.0.SelfAttention.{key}.weight"] = \
                _t(np.asarray(attn["SelfAttention"][key]["kernel"]).T)
        if "relative_attention_bias" in attn["SelfAttention"]:
            sd[f"{base}.0.SelfAttention.relative_attention_bias.weight"] = \
                _t(attn["SelfAttention"]["relative_attention_bias"]
                   ["embedding"])
        for key in ("wi_0", "wi_1", "wo"):
            sd[f"{base}.1.DenseReluDense.{key}.weight"] = \
                _t(np.asarray(ff["DenseReluDense"][key]["kernel"]).T)
        sd[f"{base}.0.layer_norm.weight"] = _t(attn["layer_norm"]["weight"])
        sd[f"{base}.1.layer_norm.weight"] = _t(ff["layer_norm"]["weight"])
    sd["encoder.final_layer_norm.weight"] = \
        _t(enc["final_layer_norm"]["weight"])
    return sd


def _conv(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[f"{name}.bias"] = _t(p["bias"])


def _pointwise(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _gn(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _res(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _gn(sd, f"{name}.norm1", p["norm1"])
    _conv(sd, f"{name}.conv1", p["conv1"])
    _gn(sd, f"{name}.norm2", p["norm2"])
    _conv(sd, f"{name}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _pointwise(sd, f"{name}.nin_shortcut", p["nin_shortcut"])


def _attn(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _gn(sd, f"{name}.norm", p["norm"])
    for key in ("q", "k", "v", "proj_out"):
        _pointwise(sd, f"{name}.{key}", p[key])


def vq_state_dict_from_jax(params: Mapping[str, Any],
                           cfg: VQConfig) -> StateDict:
    """JAX `models.vq` params (numpy) -> the upstream VQModel state dict,
    encoder included (the port's `VQModel` loads the decode half)."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, level in enumerate(enc["down"]):
        base = f"encoder.conv_blocks.{i}"
        for j, res in enumerate(level["res"]):
            _res(sd, f"{base}.res.{j}", res)
        for j, attn in enumerate(level["attn"]):
            _attn(sd, f"{base}.attn.{j}", attn)
        if "downsample" in level:
            _conv(sd, f"{base}.downsample.conv", level["downsample"]["conv"])
    for prefix, part in (("encoder", enc), ("decoder", dec)):
        _res(sd, f"{prefix}.mid.0", part["mid"][0])
        _attn(sd, f"{prefix}.mid.1", part["mid"][1])
        _res(sd, f"{prefix}.mid.2", part["mid"][2])
        _gn(sd, f"{prefix}.norm_out", part["norm_out"])
        _conv(sd, f"{prefix}.conv_out", part["conv_out"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    for i, level in enumerate(dec["up"]):
        base = f"decoder.conv_blocks.{i}"
        for j, res in enumerate(level["res"]):
            _res(sd, f"{base}.res.{j}", res)
        for j, attn in enumerate(level["attn"]):
            _attn(sd, f"{base}.attn.{j}", attn)
        if "upsample" in level:
            _conv(sd, f"{base}.upsample.conv", level["upsample"]["conv"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    sd["quantize.embedding.weight"] = _t(params["quantize"]["codebook"])
    return sd
