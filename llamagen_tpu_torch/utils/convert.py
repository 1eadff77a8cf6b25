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
`patchgan_state_dict_from_jax`, `stylegan_state_dict_from_jax` and
`lpips_state_dict_from_jax` carry the VQ-GAN's discriminators and LPIPS
(`llamagen_tpu/models/{discriminator,lpips}.py`) into the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from llamagen_tpu_torch.config import GPTConfig, VQConfig
from llamagen_tpu_torch.models.lpips import VGG16_CONVS, slice_of

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


def _same(x) -> torch.Tensor:
    """An array as a tensor of its own dtype (int8 levels stay int8)."""
    return torch.from_numpy(np.array(x))


def _quantized(sd: StateDict, name: str, p: Mapping[str, Any], key: str,
               i: Optional[int] = None) -> bool:
    """A quantised JAX entry `key` (W8A16 `{key}_q` [K, N] int8 +
    `{key}_scale` [N]; W4 `{key}_w4b` + `{key}_w4s` in the kernel layout;
    per layer when `i` is given) -> `{name}.weight_q` / `weight_scale` /
    `weight_w4b` / `weight_w4s`, which hold the same layouts. False when
    `key` is not quantised."""
    for jax_keys, attrs in ((("_q", "_scale"), ("q", "scale")),
                            (("_w4b", "_w4s"), ("w4b", "w4s"))):
        if key + jax_keys[0] not in p:
            continue
        for sfx, attr in zip(jax_keys, attrs):
            v = np.asarray(p[key + sfx])
            sd[f"{name}.weight_{attr}"] = _same(v if i is None else v[i])
        return True
    return False


def gpt_state_dict_from_jax(params: Mapping[str, Any],
                            cfg: GPTConfig) -> StateDict:
    """JAX `models.gpt` params (numpy) -> port `Transformer` state dict
    (c2i: the class table; t2i: the caption MLP and `uncond_embedding`,
    JAX `utils/convert.py:195-203` inverted). Quantised layer matmuls
    (W8A16 `_q` / `_scale`, W4 `_w4b` / `_w4s`, stacked per layer in JAX)
    and an int8 head (`output_q` / `output_scale`) carry over as they are:
    a quantised `Linear` of the port keeps JAX's layouts. Load such a dict
    after `cli/common.py::shape_quantized_linears`."""
    layers = params["layers"]
    cls = params["cls_embedding"]
    sd = {"tok_embeddings.weight": _t(params["tok_embeddings"]),
          "norm.weight": _t(params["norm"])}
    if not _quantized(sd, "output", params, "output"):
        sd["output.weight"] = _t(np.asarray(params["output"]).T)
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
            if not _quantized(sd, f"layers.{i}.{name}", layers, key, i):
                sd[f"layers.{i}.{name}.weight"] = \
                    _t(np.asarray(layers[key][i]).T)
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


def _bn(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    """BatchNorm scale and bias, and the running buffers upstream keys
    hold (never read by the port's batch-statistics BatchNorm)."""
    _gn(sd, name, p)
    c = np.asarray(p["scale"]).shape[0]
    sd[f"{name}.running_mean"] = torch.zeros(c)
    sd[f"{name}.running_var"] = torch.ones(c)
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def patchgan_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX `init_patchgan` params -> the `NLayerDiscriminator` state dict
    (`main.{i}`: the first conv at 0, (conv, BatchNorm) at 2 + 3i and
    3 + 3i, the last conv after them; JAX `convert_patchgan` inverted)."""
    convs, norms = params["convs"], params["norms"]
    sd: StateDict = {}
    _conv(sd, "main.0", convs[0])
    for i, norm in enumerate(norms):
        sd[f"main.{2 + 3 * i}.weight"] = \
            _t(np.transpose(convs[i + 1]["kernel"], (3, 2, 0, 1)))
        _bn(sd, f"main.{3 + 3 * i}", norm)
    _conv(sd, f"main.{2 + 3 * len(norms)}", convs[-1])
    return sd


def stylegan_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX `init_stylegan` params -> the upstream StyleGAN `Discriminator`
    state dict, computing what JAX computes.

    JAX flattens the final [B, 4, 4, C] map in NHWC order before `fc1`;
    upstream (and the port) flattens [B, C, 4, 4]. So `fc1`'s input rows
    are reordered from (h, w, c) to (c, h, w): JAX `convert_stylegan` does
    not reorder them (ROADMAP F8)."""
    sd: StateDict = {}
    _conv(sd, "blocks.0", params["conv_in"])
    for i, blk in enumerate(params["blocks"]):
        base = f"blocks.{i + 2}"
        _conv(sd, f"{base}.conv_res", blk["conv_res"])
        _conv(sd, f"{base}.net.0", blk["conv1"])
        _conv(sd, f"{base}.net.2", blk["conv2"])
        sd[f"{base}.downsample.0.f"] = torch.tensor([1.0, 2.0, 1.0])
        _conv(sd, f"{base}.downsample.1", blk["down"])
    _conv(sd, "final_conv.0", params["final_conv"])
    fc1 = np.asarray(params["fc1"]["kernel"])  # [(h, w, c), out]
    c = np.asarray(params["final_conv"]["kernel"]).shape[-1]
    side = int(round((fc1.shape[0] // c) ** 0.5))
    sd["final_linear.0.weight"] = _t(
        fc1.reshape(side, side, c, -1).transpose(3, 2, 0, 1)
        .reshape(fc1.shape[1], -1))
    sd["final_linear.0.bias"] = _t(params["fc1"]["bias"])
    sd["final_linear.2.weight"] = _t(np.asarray(params["fc2"]["kernel"]).T)
    sd["final_linear.2.bias"] = _t(params["fc2"]["bias"])
    return sd


def lpips_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX `models.lpips` params ({"vgg": {"convs"}, "lins"}) -> the port's
    `LPIPS` state dict (`net.slice{n}.{i}` at torchvision's conv indices,
    `lin{k}.model.1.weight` [1, C, 1, 1])."""
    sd: StateDict = {}
    for i, conv in zip(VGG16_CONVS, params["vgg"]["convs"]):
        _conv(sd, f"net.slice{slice_of(i)}.{i}", conv)
    for k, lin in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = \
            _t(np.asarray(lin["kernel"]).T[:, :, None, None])
    return sd


# ---------------------------------------------------------------------------
# Evaluation networks (weights-gated; tests carry random JAX / Flax ones)
# ---------------------------------------------------------------------------


def inception_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX `eval/inception.py` params (`init_params` or `convert_inception`
    output: per conv an HWIO kernel and the BatchNorm's scale, bias, mean
    and variance) -> pytorch-fid's keys (the port's `FIDInceptionV3`)."""
    sd: StateDict = {}

    def conv_bn(name, p):
        sd[f"{name}.conv.weight"] = _t(np.transpose(p["kernel"],
                                                    (3, 2, 0, 1)))
        for key, attr in (("bn_scale", "weight"), ("bn_bias", "bias"),
                          ("bn_mean", "running_mean"),
                          ("bn_var", "running_var")):
            sd[f"{name}.bn.{attr}"] = _t(p[key])

    for name, p in params.items():
        if name == "fc":
            continue
        if "kernel" in p:
            conv_bn(name, p)
        else:
            for branch, q in p.items():
                conv_bn(f"{name}.{branch}", q)
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def clip_state_dict_from_flax(params: Mapping[str, Any]) -> StateDict:
    """HF `FlaxCLIPModel` params (numpy) -> HF `CLIPModel`'s torch keys
    (the port's `eval/clip.py::CLIPModel`): Dense kernels `[in, out]`
    transposed, the patch conv HWIO -> OIHW, LayerNorm `scale` and
    embedding tables renamed `weight`."""
    sd: StateDict = {}

    def walk(prefix, node):
        for key, value in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(name, value)
                continue
            v = np.asarray(value)
            if key == "kernel":
                v = v.T if v.ndim == 2 else np.transpose(v, (3, 2, 0, 1))
            if key in ("kernel", "scale", "embedding"):
                name = f"{prefix}.weight"
            sd[name] = _t(v)

    walk("", params)
    return sd


# ---------------------------------------------------------------------------
# Baseline tokenizers: SD-VAE, taming VQGAN, the consistency decoder
# (numpy-only copies of the JAX package's key handling)
# ---------------------------------------------------------------------------

_BASELINE_PREFIXES = ("encoder.", "decoder.", "quant_conv.",
                      "post_quant_conv.", "quantize.embedding.")


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The same entries with trainer prefixes (`module.`, `_orig_mod.`)
    removed from their names."""
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "_orig_mod."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def _numpy_f32(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Prefixes stripped, values f32 numpy (tensors of any dtype too)."""
    return {k: v.detach().float().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v, np.float32)
            for k, v in strip_prefixes(sd).items()}


def diffusers_vae_to_ldm_keys(sd: Mapping[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """Rename a diffusers AutoencoderKL state dict into the LDM layout
    (the inverse of diffusers' own `convert_ldm_vae_checkpoint` mapping)
    so one loader serves both layouts."""
    import re

    # count decoder up levels to reverse the block index (diffusers
    # up_blocks[0] is the LOWEST resolution; ldm up.{level} indexes by
    # level with 0 = highest)
    ups = {int(m.group(1)) for k in sd
           if (m := re.match(r"decoder\.up_blocks\.(\d+)\.", k))}
    nlev = (max(ups) + 1) if ups else 0

    out = {}
    for k, v in sd.items():
        k = k.replace("mid_block.resnets.0.", "mid.block_1.")
        k = k.replace("mid_block.resnets.1.", "mid.block_2.")
        k = k.replace("mid_block.attentions.0.group_norm.",
                      "mid.attn_1.norm.")
        k = k.replace("mid_block.attentions.0.to_q.", "mid.attn_1.q.")
        k = k.replace("mid_block.attentions.0.to_k.", "mid.attn_1.k.")
        k = k.replace("mid_block.attentions.0.to_v.", "mid.attn_1.v.")
        k = k.replace("mid_block.attentions.0.to_out.0.",
                      "mid.attn_1.proj_out.")
        k = k.replace("conv_norm_out.", "norm_out.")
        k = k.replace(".conv_shortcut.", ".nin_shortcut.")
        m = re.match(r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", k)
        if m:
            k = f"encoder.down.{m.group(1)}.block.{m.group(2)}.{m.group(3)}"
        m = re.match(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)", k)
        if m:
            k = f"encoder.down.{m.group(1)}.downsample.conv.{m.group(2)}"
        m = re.match(r"decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)", k)
        if m:
            lev = nlev - 1 - int(m.group(1))
            k = f"decoder.up.{lev}.block.{m.group(2)}.{m.group(3)}"
        m = re.match(r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)", k)
        if m:
            lev = nlev - 1 - int(m.group(1))
            k = f"decoder.up.{lev}.upsample.conv.{m.group(2)}"
        out[k] = np.asarray(v)
    return out


def sd_vae_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """An SD-VAE (AutoencoderKL) state dict in the LDM or the diffusers
    layout -> the port's `models/klvae.py::AutoencoderKL` (LDM keys):
    diffusers' Linear attention projections become 1x1 convolutions; keys
    outside the autoencoder (an LDM checkpoint's `loss.*`) are left out."""
    sd = _numpy_f32(sd)
    if any(k.startswith("encoder.down_blocks.") for k in sd):
        sd = diffusers_vae_to_ldm_keys(sd)
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith(_BASELINE_PREFIXES):
            continue
        if ".attn_1." in k and k.endswith(".weight") and v.ndim == 2:
            v = v[:, :, None, None]
        out[k] = _t(v)
    return out


def taming_vq_config(name: str) -> VQConfig:
    """taming config presets (the yaml params of upstream's
    tokenizer/vqgan/configs/*.yaml); the codebook is not l2-normalised."""
    presets = {
        "vqgan_imagenet_f16_1024": dict(
            codebook_size=1024, codebook_embed_dim=256,
            encoder_ch_mult=(1, 1, 2, 2, 4), decoder_ch_mult=(1, 1, 2, 2, 4)),
        "vqgan_imagenet_f16_16384": dict(
            codebook_size=16384, codebook_embed_dim=256,
            encoder_ch_mult=(1, 1, 2, 2, 4), decoder_ch_mult=(1, 1, 2, 2, 4)),
        "vqgan_openimage_f8_256": dict(
            codebook_size=256, codebook_embed_dim=4,
            encoder_ch_mult=(1, 2, 2, 4), decoder_ch_mult=(1, 2, 2, 4)),
        "vqgan_openimage_f8_16384": dict(
            codebook_size=16384, codebook_embed_dim=4,
            encoder_ch_mult=(1, 2, 2, 4), decoder_ch_mult=(1, 2, 2, 4)),
    }
    return VQConfig(codebook_l2_norm=False, **presets[name])


def taming_vq_state_dict(sd: Mapping[str, Any], cfg: VQConfig) -> StateDict:
    """A CompVis taming VQModel state dict -> the upstream LlamaGen VQModel
    keys (the port's `VQModel(cfg, encoder=True)`), as the JAX package's
    `convert_taming_vq` maps it: encoder `down.{i}.block.{j}` / `attn.{j}`
    / `downsample` -> `conv_blocks.{i}.res.{j}` / `attn.{j}` /
    `downsample`; `mid.block_1` / `attn_1` / `block_2` -> `mid.0` / `1` /
    `2`; decoder `up.{level}` (applied from the lowest resolution) ->
    `conv_blocks.{n - 1 - level}` (application order). Valid for the
    configs upstream ships, whose attention sits exactly at the lowest
    level; the loss's keys are left out."""
    import re

    sd = _numpy_f32(sd)
    n_dec = len(cfg.decoder_ch_mult)
    last = len(cfg.encoder_ch_mult) - 1
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith(_BASELINE_PREFIXES):
            continue
        for part in ("encoder", "decoder"):
            for src, dst in (("block_1", "0"), ("attn_1", "1"),
                             ("block_2", "2")):
                k = k.replace(f"{part}.mid.{src}.", f"{part}.mid.{dst}.")
        m = re.match(r"encoder\.down\.(\d+)\.(block|attn|downsample)\.(.*)",
                     k)
        if m:
            i, kind, rest = int(m.group(1)), m.group(2), m.group(3)
            if kind == "attn" and i != last:
                raise ValueError("taming checkpoint places attention away "
                                 "from the lowest level: unsupported")
            kind = {"block": "res"}.get(kind, kind)
            k = f"encoder.conv_blocks.{i}.{kind}.{rest}"
        m = re.match(r"decoder\.up\.(\d+)\.(block|attn|upsample)\.(.*)", k)
        if m:
            level, kind, rest = int(m.group(1)), m.group(2), m.group(3)
            if kind == "attn" and level != n_dec - 1:
                raise ValueError("taming checkpoint places attention away "
                                 "from the lowest level: unsupported")
            kind = {"block": "res"}.get(kind, kind)
            k = f"decoder.conv_blocks.{n_dec - 1 - level}.{kind}.{rest}"
        out[k] = _t(v)
    return out


def consistency_decoder_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """An openai ConvUNetVAE state dict -> the port's
    `models/consistency_decoder.py::ConvUNetVAE` (the same keys, trainer
    prefixes removed). Load it strictly: a key the port does not hold, or
    one it misses, fails loudly (the JAX converter's full-coverage
    assertion)."""
    return {k: _t(v) for k, v in _numpy_f32(sd).items()}
