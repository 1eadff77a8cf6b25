"""Model configurations of the port: the VQ tokenizer and the GPT family.

The port's own copy of `llamagen_tpu/config.py` (the same dataclasses,
fields, defaults and model zoo), so the port imports nothing of the JAX
package. `tests/test_torch_isolation.py` holds the two zoos equal field by
field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def find_multiple(n: int, k: int) -> int:
    """Round n up to the next multiple of k."""
    return n if n % k == 0 else n + k - (n % k)


# ---------------------------------------------------------------------------
# VQ-VAE tokenizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VQConfig:
    """VQ-VAE config (upstream vq_model.py:12-24).

    The encoder downsamples by 2**(len(encoder_ch_mult)-1): 16x for VQ-16,
    8x for VQ-8. The codebook is L2-normalized by default.
    """

    codebook_size: int = 16384
    codebook_embed_dim: int = 8
    codebook_l2_norm: bool = True
    commit_loss_beta: float = 0.25
    entropy_loss_ratio: float = 0.0
    encoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    decoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    z_channels: int = 256
    ch: int = 128
    num_res_blocks: int = 2
    dropout_p: float = 0.0

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.encoder_ch_mult) - 1)


def vq_16(**kw) -> VQConfig:
    return VQConfig(encoder_ch_mult=(1, 1, 2, 2, 4),
                    decoder_ch_mult=(1, 1, 2, 2, 4), **kw)


def vq_8(**kw) -> VQConfig:
    return VQConfig(encoder_ch_mult=(1, 2, 2, 4),
                    decoder_ch_mult=(1, 2, 2, 4), **kw)


VQ_CONFIGS = {"VQ-16": vq_16, "VQ-8": vq_8}


# ---------------------------------------------------------------------------
# GPT family
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GPTConfig:
    """Llama-style decoder-only transformer config (upstream gpt.py:23-50)."""

    dim: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    initializer_range: float = 0.02

    token_dropout_p: float = 0.1
    attn_dropout_p: float = 0.0
    resid_dropout_p: float = 0.1
    ffn_dropout_p: float = 0.1
    drop_path_rate: float = 0.0

    num_classes: int = 1000
    caption_dim: int = 2048
    class_dropout_prob: float = 0.1
    model_type: str = "c2i"  # 'c2i' or 't2i'

    vocab_size: int = 16384
    cls_token_num: int = 1
    block_size: int = 256  # latent grid area (grid_size ** 2)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def grid_size(self) -> int:
        g = int(self.block_size ** 0.5)
        assert g * g == self.block_size, "block_size must be a perfect square"
        return g

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size (upstream gpt.py:151-159)."""
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return find_multiple(hidden, self.multiple_of)

    @property
    def max_seq_len(self) -> int:
        return self.cls_token_num + self.block_size


def _gpt(dim, n_layer, n_head, **kw) -> GPTConfig:
    return GPTConfig(dim=dim, n_layer=n_layer, n_head=n_head, **kw)


# Model zoo (upstream gpt.py:438-467). Sizes: B 111M, L 343M, XL 775M,
# XXL 1.4B, XXXL 3.9B, 1B 1.2B, 3B 3.1B (head_dim=100!), 7B 6.6B.
GPT_CONFIGS = {
    # tiny config for smoke tests (not in the upstream zoo)
    "GPT-nano": lambda **kw: _gpt(128, 2, 2, **kw),
    "GPT-B": lambda **kw: _gpt(768, 12, 12, **kw),
    "GPT-L": lambda **kw: _gpt(1024, 24, 16, **kw),
    "GPT-XL": lambda **kw: _gpt(1280, 36, 20, **kw),
    "GPT-XXL": lambda **kw: _gpt(1536, 48, 24, **kw),
    "GPT-XXXL": lambda **kw: _gpt(2560, 48, 40, **kw),
    "GPT-1B": lambda **kw: _gpt(2048, 22, 32, **kw),
    "GPT-3B": lambda **kw: _gpt(3200, 24, 32, **kw),
    "GPT-7B": lambda **kw: _gpt(4096, 32, 32, **kw),
}


def gpt_config(name: str, **kw) -> GPTConfig:
    return GPT_CONFIGS[name](**kw)


def vq_config(name: str, **kw) -> VQConfig:
    return VQ_CONFIGS[name](**kw)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
