"""The port's tokenizer CLIs and metrics (cli.extract_codes,
cli.reconstruction_vq, cli.vq_demo, eval.metrics) on the CPU, against the
JAX package where it has the same function: `center_crop`, `ten_crop`,
PSNR / SSIM equal (the same numpy arithmetic); code shards equal the
port's `encode` of the same crops and load through `data/codes.py`."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from llamagen_tpu.cli import extract_codes as jextract
from llamagen_tpu.eval import metrics as jmetrics
from llamagen_tpu_torch.cli import extract_codes, reconstruction_vq, vq_demo
from llamagen_tpu_torch.cli.common import load_vq
from llamagen_tpu_torch.data.codes import PackedCodeDataset
from llamagen_tpu_torch.eval import metrics
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

SIZE = 32  # VQ-16 at full width: 2 x 2 codes a crop
SIZES = [(40, 48), (70, 33), (33, 33), (100, 80), (36, 50)]


@pytest.fixture
def folder(tmp_path):
    """An ImageFolder of 5 PNGs in 2 classes (one image at least twice the
    crop on its short side) and a file that is not an image."""
    from PIL import Image

    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(SIZES):
        d = tmp_path / "data" / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"img{i}.png"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    (tmp_path / "data" / "class0" / "broken.png").write_bytes(b"no image")
    return tmp_path / "data"


def _open(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


@pytest.mark.parametrize("size", [16, 32, 35])
def test_center_crop_and_ten_crop_equal_jax(size):
    from PIL import Image

    rng = np.random.RandomState(size)
    for w, h in SIZES:
        img = Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        got = extract_codes.center_crop(img, size)
        np.testing.assert_array_equal(got, jextract.center_crop(img, size))
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        big = extract_codes.center_crop(img, size + 3)
        for a, b in zip(extract_codes.ten_crop(big, size),
                        jextract.ten_crop(big, size)):
            np.testing.assert_array_equal(a, b)


def test_metrics_equal_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
    assert metrics.ssim(a[..., 0], b[..., 0]) == \
        jmetrics.ssim(a[..., 0], b[..., 0])
    x = rng.uniform(-1.5, 1.5, (4, 5)).astype(np.float32)
    np.testing.assert_array_equal(metrics.images_to_unit_range(x),
                                  jmetrics.images_to_unit_range(x))


@pytest.mark.parametrize("mode", ["plain", "flip", "ten_crop"])
def test_extract_codes_shards(folder, tmp_path, mode):
    """Shards of batches of 4 crops, 2 samples a shard: the codes equal
    the port's `encode` of the same crops (f32, the CLI's seeded random
    VQ-16), labels by class, and `PackedCodeDataset` reads them."""
    out = tmp_path / f"codes_{mode}"
    flag = {"plain": [], "flip": ["--flip-aug"],
            "ten_crop": ["--ten-crop"]}[mode]
    total = extract_codes.main(
        ["--data-path", str(folder), "--out-dir", str(out), "--image-size",
         str(SIZE), "--batch-size", "4", "--shard-size", "2",
         "--device", "cpu"] + flag)
    assert total == len(SIZES)  # the broken file is skipped
    naug = {"plain": 1, "flip": 2, "ten_crop": 10}[mode]
    codes = np.concatenate([np.load(p) for p in
                            sorted(out.glob("*.codes.npy"))])
    labels = np.concatenate([np.load(p) for p in
                             sorted(out.glob("*.labels.npy"))])
    assert codes.dtype == labels.dtype == np.int16
    assert codes.shape == ((5, 4) if naug == 1 else (5, naug, 4))
    assert labels.tolist() == [0, 0, 0, 1, 1]  # class0: img0, 2, 4

    vq_model = load_vq(None, "VQ-16", 16384, 8, torch.float32,
                       torch.device("cpu"), encoder=True)
    order = [0, 2, 4, 1, 3]  # ImageFolder order: class0 then class1
    pre = int(SIZE * 1.1) if mode == "ten_crop" else SIZE
    crops = [c for i in order for c in extract_codes.crops_of(
        extract_codes.center_crop(_open(folder / f"class{i % 2}"
                                        / f"img{i}.png"), pre), SIZE, mode)]
    with torch.no_grad():
        x = torch.tensor(np.stack(crops)).float() / 127.5 - 1.0
        want = vq_model.encode(x)[2].reshape(5, naug, 4).numpy()
    np.testing.assert_array_equal(codes.reshape(5, naug, 4), want)
    np.testing.assert_array_equal(
        extract_codes.encode_batch(vq_model, crops, naug),
        want if naug > 1 else want[:, 0])

    ds = PackedCodeDataset(str(out))
    assert len(ds) == 5
    (got, got_labels), = ds.batches(5, seed=0, epochs=1)
    assert got.shape == (5, 4) and sorted(got_labels.tolist()) == \
        [0, 0, 0, 1, 1]


def test_reconstruction_vq(folder, tmp_path):
    """PSNR, SSIM and the uint8 dump of the round trip equal JAX
    `eval.metrics` on the same arrays; the CLI's means and usage."""
    npz = tmp_path / "rec.npz"
    res = reconstruction_vq.main(
        ["--data-path", str(folder), "--image-size", str(SIZE),
         "--batch-size", "2", "--npz-out", str(npz), "--device", "cpu"])
    assert res["images"] == 5
    vq_model = load_vq(None, "VQ-16", 16384, 8, torch.float32,
                       torch.device("cpu"), encoder=True)
    crops = [extract_codes.center_crop(_open(p), SIZE)
             for p, _ in extract_codes.iter_image_folder(str(folder))
             if "broken" not in p]
    psnrs, ssims, dump, ids = [], [], [], []
    for i in range(0, 5, 2):  # the CLI's batches of 2
        rec, idx = reconstruction_vq.roundtrip_batch(vq_model, crops[i:i + 2])
        assert rec.dtype == np.float32 and np.isfinite(rec).all()
        assert rec.shape == (len(idx), SIZE, SIZE, 3)
        assert idx.shape == (len(idx), 2, 2)
        ps, ss, u8 = reconstruction_vq.score(crops[i:i + 2], rec)
        for c, r, p, s in zip(crops[i:i + 2], rec, ps, ss):
            a = c.astype(np.float32) / 255.0
            b = jmetrics.images_to_unit_range(r)
            assert p == jmetrics.psnr(a, b) and s == jmetrics.ssim(a, b)
        psnrs += ps
        ssims += ss
        dump += list(u8)
        ids.append(idx.ravel())
    assert res["psnr"] == float(np.mean(psnrs))
    assert res["ssim"] == float(np.mean(ssims))
    assert res["codebook_usage"] == \
        len(np.unique(np.concatenate(ids))) / 16384
    with np.load(npz) as z:
        np.testing.assert_array_equal(z["arr_0"], np.stack(dump))


def test_vq_demo_writes_the_reconstruction(folder):
    from PIL import Image

    src = folder / "class1" / "img1.png"
    out = vq_demo.main(["--image", str(src), "--image-size", str(SIZE),
                        "--device", "cpu"])
    assert out == str(folder / "class1" / "img1_rec.png")
    with Image.open(out) as img:
        assert img.size == (SIZE, SIZE) and img.mode == "RGB"
