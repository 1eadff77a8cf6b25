"""The general drivers a traffic mix names (`"driver"`): `serve` for the
slot engine, `train` for the training step. Each has `run(Run) ->
Outcome`."""

from __future__ import annotations

from typing import Dict


def gpt_config(c: Dict):
    """The program's GPTConfig for a configuration file, checked against
    the file's derived sizes."""
    from llamagen_tpu_torch.config import GPTConfig

    cfg = GPTConfig(
        dim=c["dim"], n_layer=c["n_layer"], n_head=c["n_head"],
        n_kv_head=c["n_kv_head"], multiple_of=c["multiple_of"],
        rope_base=c["rope_base"], norm_eps=c["norm_eps"],
        token_dropout_p=c["train"]["token_dropout_p"],
        attn_dropout_p=c["train"]["attn_dropout_p"],
        resid_dropout_p=c["train"]["resid_dropout_p"],
        ffn_dropout_p=c["train"]["ffn_dropout_p"],
        drop_path_rate=c["train"]["drop_path_rate"],
        num_classes=c["num_classes"], caption_dim=c["caption_dim"],
        class_dropout_prob=c["class_dropout_prob"],
        model_type=c["model_type"], vocab_size=c["vocab_size"],
        cls_token_num=c["cls_token_num"], block_size=c["block_size"])
    got = (cfg.head_dim, cfg.ffn_hidden_dim)
    if got != (c["head_dim"], c["ffn_hidden_dim"]):
        raise ValueError(f"{c['name']}: head_dim, ffn_hidden_dim {got} "
                         f"differ from the file's")
    return cfg
