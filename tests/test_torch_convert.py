"""JAX params -> port state dict -> JAX converter round trip (exact), and
the port imports with JAX blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

from llamagen_tpu.models import gpt as jgpt
from llamagen_tpu.models import vq as jvq
from llamagen_tpu.utils.convert import convert_gpt, convert_vq
from llamagen_tpu_torch.config import GPTConfig, VQConfig, gpt_config
from llamagen_tpu_torch.models import gpt, vq
from llamagen_tpu_torch.utils.convert import (gpt_state_dict_from_jax,
                                              vq_state_dict_from_jax)
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("cfg", [
    gpt_config("GPT-nano", block_size=144),
    GPTConfig(dim=256, n_layer=2, n_head=4, n_kv_head=2, block_size=144)],
    ids=["nano", "gqa"])
def test_gpt_round_trip_exact(cfg):
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(jax.random.PRNGKey(0),
                                           jax_config(cfg)))
    sd = gpt_state_dict_from_jax(params, cfg)
    model = gpt.Transformer(cfg)
    model.load_state_dict(sd)  # strict: the port holds exactly these keys
    back = convert_gpt({k: v.numpy() for k, v in sd.items()},
                       jax_config(cfg))
    _assert_same_tree(params, back)


def test_vq_round_trip_exact():
    cfg = VQConfig(ch=32, encoder_ch_mult=(1, 2), decoder_ch_mult=(1, 2),
                   z_channels=64, codebook_size=256)
    params = jax.tree.map(np.asarray,
                          jvq.init_params(jax.random.PRNGKey(0),
                                          jax_config(cfg)))
    sd = vq_state_dict_from_jax(params, cfg)
    vq.VQModel(cfg).load_state_dict(vq.decode_half(sd))  # strict
    back = convert_vq({k: v.numpy() for k, v in sd.items()},
                      jax_config(cfg))
    _assert_same_tree(params, back)


def test_port_imports_without_jax():
    modules = ["llamagen_tpu_torch", "llamagen_tpu_torch.config",
               "llamagen_tpu_torch.ops._build",
               "llamagen_tpu_torch.ops.attention",
               "llamagen_tpu_torch.ops.quant_matmul",
               "llamagen_tpu_torch.ops.sampling",
               "llamagen_tpu_torch.ops.generate",
               "llamagen_tpu_torch.models.gpt", "llamagen_tpu_torch.models.vq",
               "llamagen_tpu_torch.utils.convert",
               "llamagen_tpu_torch.cli.common",
               "llamagen_tpu_torch.cli.sample_c2i"]
    code = ("import sys; sys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in modules)
            + "assert not any(m == 'jax' or m.startswith('jax.') "
              "for m in sys.modules if sys.modules[m] is not None)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_load_torch_state_dict_matches_jax_and_keeps_int8(tmp_path):
    """The port's loader gives the JAX loader's f32 arrays by default, and
    with keep_dtypes the stored dtypes (int8 quantised weights)."""
    from llamagen_tpu.utils.convert import \
        load_torch_state_dict as jload_torch_state_dict
    from llamagen_tpu_torch.utils.convert import load_torch_state_dict

    sd = {"a.weight": torch.randn(3, 4, dtype=torch.bfloat16),
          "b.weight_q": torch.randint(-127, 128, (4, 5), dtype=torch.int8),
          "step": 7}
    path = tmp_path / "ckpt.pt"
    torch.save({"model": sd}, path)
    ref = jload_torch_state_dict(str(path))
    out = load_torch_state_dict(str(path))
    assert out.keys() == ref.keys() == {"a.weight", "b.weight_q"}
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    kept = load_torch_state_dict(str(path), keep_dtypes=True)
    assert kept["b.weight_q"].dtype == torch.int8
    assert torch.equal(kept["b.weight_q"], sd["b.weight_q"])
    assert torch.equal(kept["a.weight"], sd["a.weight"])
