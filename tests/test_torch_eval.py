"""The port's evaluation stack (`eval/fid.py`, `eval/inception.py`,
`cli/evaluate.py`) against the JAX package's on the CPU.

Weights cross in pytorch-fid's layout: one random state dict (BatchNorm
statistics randomised too) goes to the port's `load_state_dict` and to
JAX's `convert_inception`. Tolerances: the metric functions are numpy /
scipy copies, so equal bit for bit; Inception features in f32 within 1e-4
of each output's largest |value| (two conv stacks that sum in different
orders, and BatchNorm folded on JAX's side); the five printed metrics
within 1e-3 relative (they differ only through the features).
"""

import os
import re

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.cli import evaluate as jevaluate
from llamagen_tpu.eval import fid as jfid
from llamagen_tpu.eval import inception as jinc
from llamagen_tpu_torch.cli import evaluate
from llamagen_tpu_torch.eval import fid, inception

FEATURE_TOL = 1e-4  # of each output's largest |value|
METRIC_RTOL = 1e-3


def random_inception(seed=0):
    """The port's network with random weights and BatchNorm statistics,
    and its state dict (pytorch-fid's keys)."""
    model = inception.FIDInceptionV3()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan) ** 0.5, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        model.fc.weight.normal_(0.0, 0.02, generator=g)
        model.fc.bias.normal_(0.0, 0.02, generator=g)
    return model.eval(), model.state_dict()


@pytest.fixture(scope="module")
def nets():
    """(port FIDInceptionV3, its pytorch-fid state dict, the JAX
    extractor on the same weights)."""
    model, sd = random_inception(seed=0)
    ex = jinc.FeatureExtractor.__new__(jinc.FeatureExtractor)
    ex.params = jax.tree.map(jnp.asarray, jinc.convert_inception(
        {k: v.numpy() for k, v in sd.items()}))
    ex.batch_size = 64
    ex._apply = jax.jit(jinc.apply)
    return model, sd, ex


def test_fid_functions_equal_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    a = rng.randn(40, 16).astype(np.float32)
    b = (rng.randn(40, 16) * 1.3 + 0.2).astype(np.float32)
    for x, y in zip(fid.activation_statistics(a),
                    jfid.activation_statistics(a)):
        np.testing.assert_array_equal(x, y)
    stats = (*fid.activation_statistics(a), *fid.activation_statistics(b))
    assert fid.frechet_distance(*stats) == jfid.frechet_distance(*stats)
    assert fid.fid_from_activations(a, b) == jfid.fid_from_activations(a, b)
    # a singular product: sqrtm is not finite and the eps offset runs
    z = np.zeros((3, 3))
    assert fid.frechet_distance(np.zeros(3), z, np.ones(3), z) == \
        jfid.frechet_distance(np.zeros(3), z, np.ones(3), z)
    logits = rng.randn(30, 10)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    assert fid.inception_score(probs, split_size=7) == \
        jfid.inception_score(probs, split_size=7)
    np.testing.assert_array_equal(fid.manifold_radii(a, batch=16),
                                  jfid.manifold_radii(a, batch=16))
    assert fid.precision_recall(a, b) == jfid.precision_recall(a, b)


def test_frechet_distance_runs_on_scipy_without_disp(monkeypatch):
    """scipy 1.18 (the card machine's) removed sqrtm's `disp` argument;
    JAX's `frechet_distance` still passes it (ROADMAP F11). Emulated here
    on the installed scipy: the port's copy runs, JAX's raises."""
    import scipy.linalg

    sqrtm = scipy.linalg.sqrtm

    def sqrtm_118(a, **kw):
        if "disp" in kw:
            raise TypeError("sqrtm() got an unexpected keyword argument "
                            "'disp'")
        return sqrtm(a, **kw)

    rng = np.random.RandomState(1)
    stats = (*fid.activation_statistics(rng.randn(20, 4)),
             *fid.activation_statistics(rng.randn(20, 4) + 0.5))
    want = fid.frechet_distance(*stats)
    monkeypatch.setattr(scipy.linalg, "sqrtm", sqrtm_118)
    assert fid.frechet_distance(*stats) == want
    with pytest.raises(TypeError, match="disp"):
        jfid.frechet_distance(*stats)


@pytest.mark.parametrize("size", [299, 256, 384])
def test_inception_features_match_jax(nets, size):
    """2 images: at 299 px no resize runs; 256 and 384 go through each
    side's preprocess (bilinear up, antialiased bilinear down)."""
    model, _, jex = nets
    images = np.random.RandomState(size).randint(
        0, 256, (2, size, size, 3), np.uint8)
    ex = inception.FeatureExtractor.__new__(inception.FeatureExtractor)
    ex.model, ex.device, ex.batch_size = model, torch.device("cpu"), 64
    got = ex.features(images)
    want = jex.features(images)
    for name, g, w in zip(("pool3", "spatial", "logits"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = np.abs(g - w).max()
        assert err <= FEATURE_TOL * np.abs(w).max(), (name, err)
    assert got[1].shape == (2, 17 * 17 * 7)


def test_features_from_batches_equals_features(nets):
    model, _, _ = nets
    images = np.random.RandomState(2).randint(0, 256, (6, 32, 32, 3),
                                              np.uint8)
    ex = inception.FeatureExtractor.__new__(inception.FeatureExtractor)
    ex.model, ex.device, ex.batch_size = model, torch.device("cpu"), 4
    full = ex.features(images)
    streamed = ex.features_from_batches([images[:4], images[4:]])
    for a, b in zip(full, streamed):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_extractor_loads_a_pytorch_fid_file(nets, tmp_path):
    model, sd, _ = nets
    path = str(tmp_path / "pt_inception.pth")
    torch.save({k: v for k, v in sd.items()
                if "num_batches_tracked" not in k}, path)
    ex = inception.FeatureExtractor(path, batch_size=2, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(ex.model.state_dict()[k], v), k


@pytest.mark.parametrize("kind", ["npy", "npz", "npz_compressed"])
def test_stream_npz_equals_jax(tmp_path, kind):
    arr = np.random.RandomState(0).randint(0, 256, (11, 8, 8, 3), np.uint8)
    path = str(tmp_path / ("batch.npy" if kind == "npy" else "batch.npz"))
    if kind == "npy":
        np.save(path, arr)
    elif kind == "npz":
        np.savez(path, arr_0=arr)
    else:
        np.savez_compressed(path, arr_0=arr)
    got = list(evaluate.stream_npz(path, batch_size=4))
    want = list(jevaluate.stream_npz(path, batch_size=4))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), arr)


def _panel(txt_path):
    with open(txt_path) as f:
        return {m.group(1): float(m.group(2))
                for m in re.finditer(r"^(.+): ([-\d.e+naninf]+)$", f.read(),
                                     re.M)}


def test_evaluate_cli_matches_jax(nets, tmp_path):
    """The same two batches (the sample one a .npy, so the .txt must not
    land on it) and the same saved random .pth through both CLIs."""
    _, sd, _ = nets
    weights = str(tmp_path / "pt_inception.pth")
    torch.save(sd, weights)
    rng = np.random.RandomState(3)
    ref = rng.randint(0, 256, (10, 32, 32, 3), np.uint8)
    sample = np.clip(ref.astype(np.int32) + rng.randint(-60, 60, ref.shape),
                     0, 255).astype(np.uint8)
    ref_path = str(tmp_path / "ref.npz")
    sample_path = str(tmp_path / "sample.npy")
    np.savez(ref_path, arr_0=ref)
    np.save(sample_path, sample)
    txt = str(tmp_path / "sample.txt")

    jevaluate.main([ref_path, sample_path, "--inception-weights", weights,
                    "--batch-size", "16"])
    want = _panel(txt)
    os.remove(txt)
    got_metrics = evaluate.main([ref_path, sample_path, "--inception-weights",
                                 weights, "--batch-size", "16",
                                 "--device", "cpu"]).metrics
    got = _panel(txt)
    np.testing.assert_array_equal(np.load(sample_path), sample)
    assert list(got) == ["Inception Score", "FID", "sFID", "Precision",
                         "Recall"] == list(want)
    for name in want:
        assert abs(got[name] - want[name]) <= METRIC_RTOL * max(
            abs(want[name]), 1e-3), (name, got[name], want[name])
        assert abs(got_metrics[name] - got[name]) <= 1e-5 * max(
            abs(got[name]), 1.0)


def test_evaluate_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["a.npz", "b.npz"])
