"""Deterministic synthetic feature sets (numpy, made from a seed).

``feature_mixture`` produces high-dimensional Gaussian-mixture features
standing in for SIFT (128-d) / GIST (960-d) in the paper's experiments
(§4.2; the datasets themselves are not bundled).
"""
from __future__ import annotations

import numpy as np


def feature_mixture(n: int, d: int, n_clusters: int = 32, seed: int = 0,
                    spread: float = 0.15) -> np.ndarray:
    """Gaussian-mixture features standing in for SIFT/GIST: cluster centers
    on a low-dimensional manifold embedded in R^d (matching the intrinsic-
    dimension structure the paper's method exploits)."""
    rng = np.random.default_rng(seed)
    # centers live near a random 8-dim subspace, like real descriptors
    basis = rng.standard_normal((8, d)) / np.sqrt(8)
    centers = rng.standard_normal((n_clusters, 8)) @ basis * 3.0
    sizes = rng.multinomial(n, np.ones(n_clusters) / n_clusters)
    parts = []
    for c, m in zip(centers, sizes):
        parts.append(c + spread * rng.standard_normal((m, d)))
    x = np.concatenate(parts).astype(np.float32)
    return x[rng.permutation(n)]


def sift_like(n: int = 16384, seed: int = 0) -> np.ndarray:
    """128-d stand-in for the SIFT descriptors of paper §4.2."""
    return feature_mixture(n, 128, n_clusters=64, seed=seed)


def gist_like(n: int = 16384, seed: int = 0) -> np.ndarray:
    """960-d stand-in for the GIST descriptors of paper §4.2."""
    return feature_mixture(n, 960, n_clusters=48, seed=seed)
