"""CLIP score for t2i evaluation, in plain PyTorch (the port's counterpart
of `llamagen_tpu/eval/clip.py`).

The GigaGAN protocol of upstream LlamaGen's
`evaluations/t2i/evaluation.py`: ViT-B/32 CLIP, image and text embeddings
L2-normalised, score = 100 * max(cosine, 0), averaged over the dataset.

`CLIPModel` is the port's own CLIP (both towers) under HF
`transformers.CLIPModel`'s torch keys, so a local HF CLIP directory's
`pytorch_model.bin` / `model.safetensors` loads with `load_state_dict`:
pre-LN blocks with quick_gelu; the vision tower prepends the class token,
runs `pre_layrnorm` (HF's spelling), pools the class token through
`post_layernorm` and `visual_projection`; the text tower runs a causal
mask together with the attention mask and pools at
`input_ids.argmax(-1)` (the end-of-text token, as `FlaxCLIPTextTransformer`
pools) through `final_layer_norm` and `text_projection`. Only the
tokenizer comes from `transformers`, in `ClipScorer`'s constructor.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# openai CLIP preprocessing constants (the `clip` package's _transform:
# Resize(224, bicubic) + CenterCrop + normalize)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(images_uint8: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 [N,H,W,3] -> normalized [N,size,size,3].

    Exactly clip._transform (the transform the reference's `clip.load`
    returns): PIL bicubic resize of the short side to `size` (antialiased),
    center crop, /255, normalize with the CLIP mean/std."""
    from PIL import Image

    out = np.empty((len(images_uint8), size, size, 3), np.float32)
    for i, arr in enumerate(images_uint8):
        img = Image.fromarray(arr)
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)),
                         Image.BICUBIC)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        out[i] = np.asarray(img, np.float32) / 255.0
    return (out - CLIP_MEAN) / CLIP_STD


@dataclass(frozen=True)
class TowerConfig:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class ClipConfig:
    """ViT-B/32 by default (openai/clip-vit-base-patch32)."""
    text: TowerConfig = TowerConfig(512, 2048, 12, 8)
    vision: TowerConfig = TowerConfig(768, 3072, 12, 12)
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    # 2 in the published ViT-B/32 config: pool at input_ids.argmax(-1)
    eos_token_id: int = 2

    @classmethod
    def from_hf(cls, d: Mapping) -> "ClipConfig":
        """From an HF `config.json` dict (its `text_config` and
        `vision_config`)."""
        def tower(c):
            return TowerConfig(c["hidden_size"], c["intermediate_size"],
                               c["num_hidden_layers"],
                               c["num_attention_heads"],
                               c.get("layer_norm_eps", 1e-5))
        t, v = d["text_config"], d["vision_config"]
        for c in (t, v):
            if c.get("hidden_act", "quick_gelu") != "quick_gelu":
                raise ValueError(f"hidden_act {c['hidden_act']}: the port's "
                                 "CLIP runs quick_gelu")
        return cls(tower(t), tower(v), t.get("vocab_size", 49408),
                   t.get("max_position_embeddings", 77),
                   v.get("image_size", 224), v.get("patch_size", 32),
                   d.get("projection_dim", 512),
                   t.get("eos_token_id", 49407))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(d, d) for _ in range(4))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, T, D]; mask [B, T, T] bool (True: attend) or None."""
        b, t, d = x.shape
        hd = d // self.heads

        def heads(proj):
            return proj(x).reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            s = s.masked_fill(~mask[:, None], torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return self.out_proj((p @ v).transpose(1, 2).reshape(b, t, d))


class MLP(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.self_attn = Attention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        d = cfg.text.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               d)


class TextTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg.text)
        self.final_layer_norm = nn.LayerNorm(cfg.text.hidden_size,
                                             eps=cfg.text.layer_norm_eps)
        self.eos_token_id = cfg.eos_token_id

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """ids, mask [B, T] -> the pooled (end-of-text) state [B, D]: at
        the highest id where the config's eos_token_id is 2 (the
        published configs, whose end-of-text id is the highest), else at
        the first eos_token_id (HF's rule, torch and Flax alike)."""
        b, t = input_ids.shape
        emb = self.embeddings
        pos = torch.arange(t, device=input_ids.device)
        x = emb.token_embedding(input_ids) + emb.position_embedding(pos)
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()
        mask = causal[None] & attention_mask.bool()[:, None, :]
        x = self.final_layer_norm(self.encoder(x, mask))
        if self.eos_token_id == 2:
            at = input_ids.argmax(-1)
        else:
            at = (input_ids == self.eos_token_id).int().argmax(-1)
        return x[torch.arange(b, device=x.device), at]


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        d = cfg.vision.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        eps = cfg.vision.layer_norm_eps
        d = cfg.vision.hidden_size
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)
        self.encoder = Encoder(cfg.vision)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NCHW pixels -> the pooled (class token) state [B, D]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    def __init__(self, cfg: ClipConfig = ClipConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = TextTransformer(cfg)
        self.vision_model = VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask))


@torch.no_grad()
def init_weights(model: CLIPModel, seed: int = 0) -> CLIPModel:
    """Seeded random weights (shape and throughput checks only): normal
    0.02 for every matrix and embedding, unit LayerNorms, zero biases."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("logit_scale"):
            continue
        if "norm" in name and name.endswith("weight"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model


def load_clip(model_dir: str, device="cuda") -> CLIPModel:
    """A local HF CLIP directory (`config.json` and `pytorch_model.bin` or
    `model.safetensors`) -> the port's model, f32, in eval mode."""
    with open(os.path.join(model_dir, "config.json")) as f:
        model = CLIPModel(ClipConfig.from_hf(json.load(f)))
    path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(path):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                        map_location="cpu", weights_only=False)
    sd = {k: v.float() for k, v in sd.items()
          if not k.endswith("position_ids")}
    model.load_state_dict(sd)
    return model.to(device).eval()


class ClipScorer:
    """Batched CLIP-score computation over (image, caption) pairs, on
    `device` (the card by default). `model` and `tokenizer` may be given
    instead of read from `model_dir` (the tokenizer is
    `transformers.CLIPTokenizerFast`, from that directory)."""

    def __init__(self, model_dir: Optional[str] = None, batch_size: int = 64,
                 device="cuda", model: Optional[CLIPModel] = None,
                 tokenizer=None):
        self.device = torch.device(device)
        if model is None:
            model = load_clip(model_dir, self.device)
        if tokenizer is None:
            from transformers import CLIPTokenizerFast
            tokenizer = CLIPTokenizerFast.from_pretrained(
                model_dir, local_files_only=True)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.image_size = model.cfg.image_size

    @torch.no_grad()
    def cosines(self, images_uint8: np.ndarray,
                captions: List[str]) -> np.ndarray:
        """cos(img_i, txt_i) per pair, f32."""
        assert len(images_uint8) == len(captions)
        out = []
        for i in range(0, len(captions), self.batch_size):
            imgs = preprocess(np.ascontiguousarray(
                images_uint8[i:i + self.batch_size]), self.image_size)
            pixels = torch.from_numpy(imgs).permute(0, 3, 1, 2) \
                .to(self.device)
            tok = self.tokenizer(captions[i:i + self.batch_size],
                                 padding="max_length", truncation=True,
                                 max_length=77, return_tensors="np")
            ids = torch.as_tensor(tok["input_ids"]).long().to(self.device)
            mask = torch.as_tensor(tok["attention_mask"]).to(self.device)
            img = self.model.get_image_features(pixels)
            txt = self.model.get_text_features(ids, mask)
            img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
            txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
            out.append((img * txt).sum(-1).float().cpu().numpy())
        return np.concatenate(out)

    def pair_scores(self, images_uint8: np.ndarray,
                    captions: List[str]) -> np.ndarray:
        """100 * max(cos(img_i, txt_i), 0) per pair."""
        return 100.0 * np.maximum(self.cosines(images_uint8, captions), 0.0)

    def score(self, images_uint8, captions) -> float:
        """Dataset-level CLIP score (the mean of the pair scores)."""
        return float(self.pair_scores(images_uint8, captions).mean())
