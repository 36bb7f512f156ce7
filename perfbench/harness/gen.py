"""Inputs made from ``--seed``: frozen copies of the program's synthetic
data generators (``repro_torch/data/pipeline.py``: ``feature_mixture``,
``sift_like``, ``token_batch``), in numpy, so that a change to the program
cannot change the yardstick's inputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def feature_mixture(n: int, d: int, n_clusters: int, seed: int,
                    spread: float) -> np.ndarray:
    """(n, d) float32 Gaussian mixture: cluster centers near a random
    8-dimensional subspace of R^d (scale 3), each point its center plus
    ``spread`` x standard normal noise, rows shuffled."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((8, d)) / np.sqrt(8)
    centers = rng.standard_normal((n_clusters, 8)) @ basis * 3.0
    sizes = rng.multinomial(n, np.ones(n_clusters) / n_clusters)
    parts = [c + spread * rng.standard_normal((m, d))
             for c, m in zip(centers, sizes)]
    x = np.concatenate(parts).astype(np.float32)
    return x[rng.permutation(n)]


def token_batch(vocab: int, step: int, batch: int, seq: int,
                seed: int) -> Dict[str, np.ndarray]:
    """A language-model batch for ``step``: Zipf-like token ids
    (``vocab * u**3``), ``tokens``/``labels`` (batch, seq) int32 shifted by
    one. Every (seed, step) gives other rows."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    u = rng.random((batch, seq + 1))
    toks = np.minimum((vocab * u ** 3).astype(np.int64),
                      vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream (a leaf of the weights, a pool of
    charges) derived from the run's seed."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def sample(seed: int, tag: int, population: int, count: int) -> np.ndarray:
    """``count`` distinct indices of ``range(population)`` drawn from the
    seed, sorted."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, tag]))
    count = min(count, population)
    return np.sort(rng.choice(population, size=count, replace=False))
