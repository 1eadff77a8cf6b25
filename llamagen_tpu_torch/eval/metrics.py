"""Image-quality metrics: PSNR and SSIM (the port's copy of
`llamagen_tpu/eval/metrics.py`).

Replace the skimage calls of upstream LlamaGen's tokenizer evaluation
(`tokenizer/tokenizer_image/reconstruction_vq_ddp.py`:
`peak_signal_noise_ratio` and `structural_similarity` with data_range 1.0
on [0, 1] float images). numpy, and scipy's `uniform_filter` for SSIM,
with skimage's defaults (gaussian_weights False, win_size 7, K1 0.01,
K2 0.03, the sample covariance).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio; inputs of one shape, any layout."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter over the two leading (spatial) axes."""
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=(size, size) + (1,) * (x.ndim - 2))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, channel_axis: int = -1) -> float:
    """Structural similarity of [H, W, C] (or [H, W]) float images, the
    mean over the region the window covers fully."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    if channel_axis != -1 and channel_axis != a.ndim - 1:
        a = np.moveaxis(a, channel_axis, -1)
        b = np.moveaxis(b, channel_axis, -1)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size ** 2
    cov_norm = n / (n - 1)  # sample covariance

    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def images_to_unit_range(x: np.ndarray) -> np.ndarray:
    """[-1, 1] model output -> [0, 1], clipped."""
    return np.clip((np.asarray(x, np.float32) + 1.0) / 2.0, 0.0, 1.0)
