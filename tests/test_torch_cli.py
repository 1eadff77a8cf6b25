"""The port's sampling CLI end to end on the CPU (GPT-nano, 2 images)."""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.cli import sample_c2i
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)


def test_sample_c2i_writes_png(tmp_path):
    from PIL import Image

    out = tmp_path / "grid.png"
    res = sample_c2i.main(["--gpt-model", "GPT-nano", "--device", "cpu",
                           "--classes", "1", "2", "--precision", "f32",
                           "--cfg-scale", "2.0", "--out", str(out)])
    assert res.tokens.shape == (2, 256)
    assert res.tokens.min() >= 0 and res.tokens.max() < 16384
    assert res.images.shape == (2, 256, 256, 3)
    assert np.isfinite(res.images).all()
    with Image.open(out) as img:  # 2 images in a 4-wide grid, 2 px padding
        assert img.size == (4 * 258 - 2, 256) and img.mode == "RGB"
        grid = np.asarray(img)
    expect = np.clip((res.images[0] + 1) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[:, :256], expect)


def test_sample_c2i_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="speculative"):
        sample_c2i.main(["--draft-gpt-model", "GPT-nano", "--device", "cpu"])
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            sample_c2i.main(["--gpt-model", "GPT-nano", "--device", "cuda",
                             "--out", str(tmp_path / "x.png")])
