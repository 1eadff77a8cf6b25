"""The port stands alone: every module of `llamagen_tpu_torch` imports in a
fresh interpreter that refuses `jax` and `llamagen_tpu`, and the port's
own copy of the model zoo equals the JAX package's, field by field."""

import dataclasses
import os
import subprocess
import sys

import pytest

from llamagen_tpu import config as jconfig
from llamagen_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = '''
import importlib, pkgutil, sys

class Refuse:
    """Meta-path hook: no module of JAX or of the JAX package loads."""
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "llamagen_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import llamagen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(llamagen_tpu_torch.__path__,
                                               "llamagen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "llamagen_tpu")]
assert not leaked, leaked
print(" ".join(names))
'''


def test_every_port_module_imports_without_jax_or_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 72  # every module was walked, parallel/'s too
    assert {"llamagen_tpu_torch.text.t5", "llamagen_tpu_torch.text.cleaning",
            "llamagen_tpu_torch.cli.sample_t2i",
            "llamagen_tpu_torch.cli.extract_t5_features",
            "llamagen_tpu_torch.models.lpips",
            "llamagen_tpu_torch.models.discriminator",
            "llamagen_tpu_torch.train.vq",
            "llamagen_tpu_torch.cli.train_vq",
            "llamagen_tpu_torch.parallel.distributed",
            "llamagen_tpu_torch.parallel.mesh",
            "llamagen_tpu_torch.parallel.partition",
            "llamagen_tpu_torch.serve.spec_engine",
            "llamagen_tpu_torch.ops.gptq", "llamagen_tpu_torch.ops.awq",
            "llamagen_tpu_torch.utils.hub",
            "llamagen_tpu_torch.cli.tools",
            # evaluation and the baseline tokenizers
            "llamagen_tpu_torch.eval.fid",
            "llamagen_tpu_torch.eval.inception",
            "llamagen_tpu_torch.eval.clip",
            "llamagen_tpu_torch.cli.evaluate",
            "llamagen_tpu_torch.cli.evaluate_t2i",
            "llamagen_tpu_torch.cli.sample_c2i_fid",
            "llamagen_tpu_torch.cli.sample_t2i_fid",
            "llamagen_tpu_torch.models.klvae",
            "llamagen_tpu_torch.models.consistency_decoder",
            "llamagen_tpu_torch.cli.reconstruction_baseline",
            # tensor parallelism, profiling and the entry points
            "llamagen_tpu_torch.parallel.tp_decode",
            "llamagen_tpu_torch.parallel.collectives",
            "llamagen_tpu_torch.utils.profiling",
            "llamagen_tpu_torch.entry"} <= names


def _fields(cfg):
    """Dataclass fields plus the derived properties the models read."""
    out = dataclasses.asdict(cfg)
    for prop in ("head_dim", "kv_heads", "ffn_hidden_dim", "max_seq_len",
                 "grid_size", "downsample_factor"):
        if hasattr(type(cfg), prop):
            out[prop] = getattr(cfg, prop)
    return out


def test_zoo_names_and_defaults_match():
    assert config.GPT_CONFIGS.keys() == jconfig.GPT_CONFIGS.keys()
    assert config.VQ_CONFIGS.keys() == jconfig.VQ_CONFIGS.keys()
    for port, ref in ((config.GPTConfig(), jconfig.GPTConfig()),
                      (config.VQConfig(), jconfig.VQConfig())):
        assert type(port) is not type(ref)  # the port's own classes
        assert _fields(port) == _fields(ref)
    assert config.find_multiple(577, 128) == jconfig.find_multiple(577, 128)


@pytest.mark.parametrize("name", sorted(jconfig.GPT_CONFIGS))
def test_gpt_zoo_matches_jax(name):
    kw = dict(block_size=576, cls_token_num=1)
    assert _fields(config.gpt_config(name, **kw)) == \
        _fields(jconfig.gpt_config(name, **kw))


@pytest.mark.parametrize("name", sorted(jconfig.VQ_CONFIGS))
def test_vq_zoo_matches_jax(name):
    assert _fields(config.vq_config(name)) == _fields(jconfig.vq_config(name))
