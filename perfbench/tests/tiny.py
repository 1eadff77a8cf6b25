"""Tiny sizes of each cell for runs on the CPU (tests only): the widths
cut so that a whole run of a cell takes seconds, the traffic alike."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

from perfbench import harness

GPT = dict(dim=64, n_layer=2, n_head=2, n_kv_head=2, head_dim=32,
           ffn_hidden_dim=256, vocab_size=64, num_classes=10)
SHRINK: Dict[str, Dict[str, Any]] = {
    "c2i-l384-serve-capacity": dict(
        GPT, block_size=16, traffic=dict(pairs=8, groups=2,
                                         group_gap_steps=8, warm_cycles=1,
                                         greedy_every=2, check_requests=2)),
    "t2i-xl256-serve-capacity": dict(
        GPT, block_size=16, cls_token_num=8, caption_dim=16,
        traffic=dict(pairs=8, groups=2, group_gap_steps=8, warm_cycles=1,
                     caption_pool=8, valid_min=2, valid_max=8,
                     greedy_every=2, check_requests=2,
                     # the mix holds no limit yet; about 4x a tiny run's
                     limits={"greedy_gap": 0.02})),
    "c2i-l384-train": dict(GPT, block_size=16, traffic=dict(batch=4)),
    "t2i-xl256-train": dict(
        GPT, block_size=16, cls_token_num=8, caption_dim=16, image_size=64,
        vq=dict(codebook_size=64, codebook_embed_dim=8,
                codebook_l2_norm=True, commit_loss_beta=0.25,
                entropy_loss_ratio=0.0, encoder_ch_mult=[1, 1, 2, 2, 4],
                decoder_ch_mult=[1, 1, 2, 2, 4], z_channels=32, ch=32,
                num_res_blocks=1, dropout_p=0.0),
        traffic=dict(batch=4, valid_min=2, valid_max=8)),
}


def tiny_run(workload: str, seed: int = 123456789012, seconds: float = 0.5,
             trace: bool = False, bench: str = "BENCHMARK.json",
             plant: Callable[[str, Any], Any] = lambda kind, obj: obj,
             extra=(), limits: Dict[str, float] = None) -> harness.Run:
    """A Run of `workload` at its tiny size on the CPU (`bench` names a
    benchmark file at the root; `limits` replaces the mix's)."""
    cell = harness.find_cell(workload, harness.ROOT / bench)
    shrink = dict(SHRINK[workload])
    if limits is not None:
        shrink["traffic"] = dict(shrink["traffic"], limits=limits)
    return harness.Run(cell, seed, seconds, trace, torch.device("cpu"),
                       time.time(), shrink=shrink, plant=plant,
                       extra=tuple(extra))
