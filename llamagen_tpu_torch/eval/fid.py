"""Generation-quality metrics on Inception activations (the port's copy
of `llamagen_tpu/eval/fid.py`, numpy and scipy only).

The math of the ADM evaluation suite (`evaluations/c2i/evaluator.py` of
upstream LlamaGen): FID / sFID (Frechet distance on pool3 / spatial
features), Inception Score, and improved Precision/Recall via manifold kNN
radii. All functions operate on activation arrays, so they are
feature-extractor agnostic: pair with `llamagen_tpu_torch.eval.inception`
(weights required) or any embedding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Activations [N, D] -> (mean [D], covariance [D, D])."""
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (ref: evaluator.py FIDStatistics.frechet_distance)."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # no `disp=False` (the JAX package's call): scipy 1.18 removed the
    # argument, and the matrix is the same without it
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_activations(acts1: np.ndarray, acts2: np.ndarray) -> float:
    return frechet_distance(*activation_statistics(acts1),
                            *activation_statistics(acts2))


def inception_score(softmax_probs: np.ndarray, split_size: int = 5000) -> float:
    """IS from class-probability rows [N, C] (ref: evaluator.py:191-204)."""
    probs = np.asarray(softmax_probs, np.float64)
    scores = []
    for i in range(0, len(probs), split_size):
        part = probs[i:i + split_size]
        kl = part * (np.log(part + 1e-10)
                     - np.log(np.expand_dims(np.mean(part, 0) + 1e-10, 0)))
        kl = np.mean(np.sum(kl, 1))
        scores.append(np.exp(kl))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Improved precision / recall (kNN manifolds; ref: evaluator.py:206-373)
# ---------------------------------------------------------------------------


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a2 = np.sum(a ** 2, axis=1, keepdims=True)
    b2 = np.sum(b ** 2, axis=1)
    d = a2 + b2 - 2.0 * a @ b.T
    return np.maximum(d, 0.0)


def manifold_radii(feats: np.ndarray, nhood_size: int = 3,
                   batch: int = 10000) -> np.ndarray:
    """Per-sample kNN radius (squared distance to the k-th neighbour)."""
    feats = np.asarray(feats, np.float32)
    n = len(feats)
    radii = np.zeros((n,), np.float32)
    for i in range(0, n, batch):
        d = _pairwise_sq_dists(feats[i:i + batch], feats)
        # k-th smallest excluding self (self-distance 0 is included in sort)
        part = np.partition(d, nhood_size, axis=1)
        radii[i:i + batch] = part[:, nhood_size]
    return radii


def points_in_manifold(points: np.ndarray, manifold_feats: np.ndarray,
                       radii: np.ndarray, batch: int = 10000) -> np.ndarray:
    """For each point: does it fall inside any manifold ball?"""
    points = np.asarray(points, np.float32)
    out = np.zeros((len(points),), bool)
    for i in range(0, len(points), batch):
        d = _pairwise_sq_dists(points[i:i + batch], manifold_feats)
        out[i:i + batch] = (d <= radii[None, :]).any(axis=1)
    return out


def precision_recall(ref_feats: np.ndarray, sample_feats: np.ndarray,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """Improved precision/recall (Kynkäänniemi et al.), as in the ADM suite."""
    ref_radii = manifold_radii(ref_feats, nhood_size)
    sample_radii = manifold_radii(sample_feats, nhood_size)
    precision = points_in_manifold(sample_feats, ref_feats, ref_radii).mean()
    recall = points_in_manifold(ref_feats, sample_feats, sample_radii).mean()
    return float(precision), float(recall)
