"""Deterministic synthetic data (numpy, made from a seed), as the
reference's ``data/pipeline.py``.

Two producers:
  token_batch(es)   — LM token streams, deterministic per (seed, step), so
                      a restarted job regenerates exactly the batches it
                      needs by step index; ``token_batches`` prefetches
                      them onto the caller's device on a thread
  feature_mixture   — high-dimensional Gaussian-mixture features standing
                      in for SIFT (128-d) / GIST (960-d) in the paper's
                      experiments (§4.2; the datasets are not bundled)
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


def token_batch(cfg, step: int, batch: int, seq: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic batch for a given step (Zipf-ish token marginals):
    the reference's arrays bit for bit. ``tokens``/``labels`` (B, S) int32
    shifted by one; a vlm model gets float32 ``embeddings`` (B, S, d) for
    its inputs, an encdec model float32 ``frames`` besides its tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipfian-ish marginal over the vocab, like natural text
    u = rng.random((batch, seq + 1))
    toks = np.minimum((cfg.vocab * u ** 3).astype(np.int64),
                      cfg.vocab - 1).astype(np.int32)
    out: Dict[str, np.ndarray] = {}
    if cfg.family in ("vlm", "encdec"):
        rngf = np.random.default_rng(np.random.SeedSequence([seed, step, 1]))
        feats = rngf.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
        if cfg.family == "vlm":
            out["embeddings"] = feats
        else:
            out["frames"] = feats
            out["tokens"] = toks[:, :-1]
    else:
        out["tokens"] = toks[:, :-1]
    out["labels"] = toks[:, 1:]
    return out


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: through pinned host memory
    and ``non_blocking`` copies to a card (the copies queue on the current
    stream, ahead of the kernels that read them)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device, copy=True)
        out[k] = t
    return out


def token_batches(cfg, batch: int, seq: int, seed: int = 0,
                  start_step: int = 0, device: DeviceLike = None,
                  prefetch: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of batches on ``device`` (``None``: the card),
    made and copied ``prefetch`` ahead on a background thread."""
    dev = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def worker():
        step = start_step
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while not stop.is_set():
            b = to_device(token_batch(cfg, step, batch, seq, seed), dev)
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


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
