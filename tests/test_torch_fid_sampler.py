"""The port's FID sampler (`cli/sample_c2i_fid.py`) against the JAX
package's on the CPU.

Per block, greedy f32 sampling (`sample_logits=False`) at the widths of
`tests/test_fid_sampler.py` gives JAX `generate`'s tokens exactly and its
decoded images within 1e-4 (uint8 within one level); the labels are
numpy's, so equal. The CLI (GPT-nano, VQ-8 at 32 px, eval size 24) writes
the same rows at one process and at two gloo ranks, and again when it is
asked for fewer samples (the blocks draw from their own generators).
"""

import dataclasses
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.cli.sample_c2i_fid import block_key
from llamagen_tpu.cli.sample_c2i_fid import block_labels as jblock_labels
from llamagen_tpu.models import vq as jvq
from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu_torch.cli import evaluate, sample_c2i_fid as fid_cli
from llamagen_tpu_torch.config import GPTConfig, vq_config
from llamagen_tpu_torch.models import vq
from llamagen_tpu_torch.utils.convert import vq_state_dict_from_jax
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from torch_ranks import launch

GPT = GPTConfig(dim=64, n_layer=2, n_head=4, block_size=16, num_classes=10,
                vocab_size=64, cls_token_num=1)
VQ = dataclasses.replace(vq_config("VQ-8", codebook_size=64,
                                   codebook_embed_dim=4), ch=32,
                         z_channels=32)
BS, LATENT, SEED = 2, 4, 0
CLI = ["--gpt-model", "GPT-nano", "--vq-model", "VQ-8", "--image-size", "32", "--downsample-size", "8",
       "--image-size-eval", "24", "--num-classes", "10",
       "--per-device-batch-size", str(BS), "--cfg-scale", "1.5",
       "--device", "cpu"]


@pytest.mark.parametrize("seed,block", [(0, 0), (0, 7), (3, 2), (12, 40)])
def test_block_labels_equal_jax(seed, block):
    np.testing.assert_array_equal(
        fid_cli.block_labels(seed, block, 32, 1000),
        jblock_labels(seed, block, 32, 1000))


@pytest.fixture(scope="module")
def pair():
    params, model = make_pair(GPT, seed=0)
    vparams = jvq.init_params(jax.random.PRNGKey(2), jax_config(VQ))
    vq_model = vq.VQModel(VQ)
    vq_model.load_state_dict(vq.decode_half(vq_state_dict_from_jax(
        jax.tree.map(np.asarray, vparams), VQ)))
    return params, model, vparams, vq_model.eval()


@pytest.mark.parametrize("block", [0, 1, 5])
def test_greedy_block_matches_jax(pair, block):
    params, model, vparams, vq_model = pair
    labels = fid_cli.block_labels(SEED, block, BS, GPT.num_classes)
    kw = dict(cfg_scale=1.5, sample_logits=False)
    want_seq = jgenerate(params, block_key(SEED, block), jnp.asarray(labels),
                         cfg=jax_config(GPT), max_new_tokens=LATENT ** 2,
                         compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                         **kw)
    want_img = np.asarray(jvq.decode_code(
        vparams, want_seq.reshape(BS, LATENT, LATENT), jax_config(VQ)))
    gen = torch.Generator().manual_seed(fid_cli.block_seed(SEED, block))
    seq, imgs = fid_cli.sample_block(model, vq_model, labels, LATENT, gen,
                                     compute_dtype=torch.float32,
                                     cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(imgs.numpy(), want_img, atol=1e-4, rtol=0)
    want_u8 = np.clip((want_img + 1) * 127.5, 0, 255).astype(np.uint8)
    diff = np.abs(fid_cli.to_uint8(imgs).astype(int) - want_u8.astype(int))
    assert diff.max() <= 1


def _rows(path):
    return np.load(path)


def test_cli_rows_do_not_depend_on_the_world_size(tmp_path):
    """6 samples in 3 blocks: one process, then two gloo ranks (rank 0
    blocks 0 and 2, rank 1 block 1, each in its own -h file)."""
    one = fid_cli.main(CLI + ["--num-samples", "6",
                              "--sample-dir", str(tmp_path / "one")])
    assert one.written == 6 and os.path.basename(one.path) == \
        "GPT-nano-32-size-24-cfg-1.5-seed-0.npy"
    rows = _rows(one.path)
    assert rows.shape == (6, 24, 24, 3) and rows.dtype == np.uint8
    assert rows.std() > 0
    res = launch("run_cli", 2, "sample_c2i_fid",
                 CLI + ["--num-samples", "6",
                        "--sample-dir", str(tmp_path / "two")])
    assert [r.written for r in res] == [4, 2]
    assert [os.path.basename(r.path)[-9:] for r in res] == \
        ["-h000.npy", "-h001.npy"]
    h0, h1 = _rows(res[0].path), _rows(res[1].path)
    for b in range(3):
        mine = h0 if b % 2 == 0 else h1
        np.testing.assert_array_equal(mine[2 * b:2 * b + 2],
                                      rows[2 * b:2 * b + 2], err_msg=str(b))
    # the rows a rank does not own stay zero
    assert not h1[:2].any() and not h0[2:4].any()


def test_cli_fewer_samples_reproduce_the_leading_blocks(tmp_path):
    full = _rows(fid_cli.main(CLI + ["--num-samples", "6", "--sample-dir",
                                     str(tmp_path / "a")]).path)
    part = _rows(fid_cli.main(CLI + ["--num-samples", "3", "--sample-dir",
                                     str(tmp_path / "b")]).path)
    np.testing.assert_array_equal(part, full[:3])


def test_cli_npz_and_the_evaluator_leave_the_npy_alone(tmp_path,
                                                       monkeypatch):
    """The panel itself is `tests/test_torch_eval.py`'s: here it is a stub
    (scipy's sqrtm of the 2048-square covariances takes tens of seconds
    on the CPU), and the evaluator writes its .txt beside the .npy."""
    res = fid_cli.main(CLI + ["--num-samples", "4", "--npz",
                              "--sample-dir", str(tmp_path)])
    rows = _rows(res.path)
    npz = res.path[:-4] + ".npz"
    np.testing.assert_array_equal(np.load(npz)["arr_0"], rows)
    monkeypatch.setattr(evaluate, "metric_panel", lambda *f: {
        name: float(len(f[2])) for name in ("Inception Score", "FID",
                                            "sFID", "Precision", "Recall")})
    metrics = evaluate.main([npz, res.path, "--device", "cpu",
                             "--batch-size", "4"])
    np.testing.assert_array_equal(_rows(res.path), rows)
    assert os.path.exists(res.path[:-4] + ".txt")
    assert len(metrics.metrics) == 5
    assert sorted(metrics.seconds) == ["metrics", "reference features",
                                       "sample features"]


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid_cli.main(["--sample-dir", str(tmp_path)])
