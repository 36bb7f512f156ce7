"""t-SNE through the PyTorch/CUDA port (paper §3.1): the twin of
``examples/tsne.py``. A synthetic high-dimensional mixture is embedded in
2-d with the attractive force computed through the paper's pipeline —
kNN affinities -> dual-tree reorder -> two-level ELL-BSR -> blockwise
iterative interactions. Repulsive forces are exact and dense (small N).

The affinities P are fixed, but the plan is ordered by the *moving*
embedding: ``plan.refresh`` re-buckets it every ``--refresh-every``
iterations, so as the embedding separates the refreshed ordering packs the
fixed pattern into denser patches (γ rises).

  python examples/tsne_torch.py [--n 1024] [--iters 300]     # on the GPU
  python examples/tsne_torch.py --device cpu --n 512 --iters 220 --k 16

On a CUDA device ``plan.tsne_attractive`` launches the hand-written
``tsne_force`` kernel; on the CPU it takes the plain blockwise path. The
run ends with "clusters separated OK".
"""
import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import resolve_device
from repro_torch.core import knn


def p_matrix(x, k, perplexity=30.0, device=None):
    """Symmetrized kNN-restricted affinities with per-point bandwidth.

    The calibration of ``examples/tsne.py`` (40 geometric bisection steps
    on beta towards the target entropy log(perplexity), in float64), run
    for all rows at once on ``device`` instead of one row at a time.
    Returns ``(rows, cols, vals)`` tensors: the pattern union of the kNN
    graph and its transpose, sorted by (row, col), values
    (p_ij + p_ji) / (2n).
    """
    dev = resolve_device(device)
    n = x.shape[0]
    idx, d2 = knn.knn_graph(x, x, k, exclude_self=True, device=dev)
    d2 = d2.double()
    lo = torch.full((n, 1), 1e-10, dtype=torch.float64, device=dev)
    hi = torch.full((n, 1), 1e10, dtype=torch.float64, device=dev)
    target = math.log(perplexity)
    for _ in range(40):
        beta = torch.sqrt(lo * hi)
        w = torch.exp(-d2 * beta)
        s = w.sum(1, keepdim=True) + 1e-30
        h = torch.log(s) + beta * (d2 * w).sum(1, keepdim=True) / s
        up = h > target
        lo = torch.where(up, beta, lo)
        hi = torch.where(up, hi, beta)
    p = (w / s).float()
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = p.reshape(-1)
    # symmetrize: every (i, j) appears at most twice (i's list, j's list),
    # so the scatter-add sums at most two values — the same float32 sum in
    # any order
    r2 = torch.cat([rows, cols])
    c2 = torch.cat([cols, rows])
    v2 = torch.cat([vals, vals]) / (2 * n)
    uniq, inv = torch.unique(r2 * n + c2, return_inverse=True)
    sums = torch.zeros(len(uniq), dtype=torch.float32, device=dev)
    sums.index_add_(0, inv, v2)
    return uniq // n, uniq % n, sums


def repulsive(y):
    """Exact dense repulsive force and normalised q (small N)."""
    diff = y[:, None] - y[None]
    q = 1.0 / (1.0 + (diff * diff).sum(-1))
    q.fill_diagonal_(0.0)
    z = q.sum()
    f = torch.einsum("ij,ijd->id", q * q / z, diff)
    return f, q / z


def separation(y, labels):
    """Total variance over mean within-label variance."""
    intra = np.mean([np.var(y[labels == c], axis=0).sum() for c in range(8)])
    return np.var(y, axis=0).sum() / max(intra, 1e-9)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--refresh-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    n, k = args.n, args.k
    labels = np.repeat(np.arange(8), n // 8)
    # one cluster per label block, as in examples/tsne.py
    rng = np.random.default_rng(1)
    basis = rng.standard_normal((8, 128)) / np.sqrt(8)
    centers = rng.standard_normal((8, 8)) @ basis * 3.0
    x = (centers[labels] + 0.15 * rng.standard_normal((n, 128))
         ).astype(np.float32)

    print("building P (kNN affinities)...")
    rows, cols, pvals = p_matrix(x, k, device=dev)

    print("planning (embedding-ordered ELL-BSR, refreshed as it moves)...")
    y0 = (0.01 * rng.standard_normal((n, 2))).astype(np.float32)
    plan = api.InteractionPlan.from_coo(rows, cols, pvals, n, x=y0, d=2,
                                        ordering="dual_tree", bs=32, sb=8,
                                        device=dev)
    labels_s = plan.permute(labels)
    print(f"  {plan}")
    print(f"  attractive force through {plan.device.type!r}: "
          f"{'the tsne_force kernel' if plan.device.type == 'cuda' else 'the plain blockwise path'}")

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    y = on_device(plan.permute(y0))
    lr, mom = float(n) / 12.0, 0.5
    vel = torch.zeros_like(y)
    t0 = time.time()
    for it in range(args.iters):
        f_attr = plan.tsne_attractive(y)
        f_rep, _ = repulsive(y)
        exagg = 4.0 if it < 100 else 1.0
        grad = 4.0 * (exagg * f_attr - f_rep)
        vel = mom * vel - lr * grad
        y = y + vel
        y = y - y.mean(0)
        if it == 120:
            mom = 0.8
        if (it + 1) % args.refresh_every == 0:
            # lifecycle refresh: re-bucket the ordering around the current
            # embedding; state vectors migrate to the new cluster order
            y_o = plan.unpermute(y.cpu().numpy())
            v_o = plan.unpermute(vel.cpu().numpy())
            plan = plan.refresh(y_o)
            y = on_device(plan.permute(y_o))
            vel = on_device(plan.permute(v_o))
            labels_s = plan.permute(labels)
            st = plan.refresh_stats
            print(f"iter {it:4d} refresh: {st.last_action:8s} "
                  f"migrated={st.last_migrated_frac:5.2f} "
                  f"gamma={plan.gamma:6.2f} fill={plan.fill:.3f}")
        if it % 100 == 0 or it == args.iters - 1:
            print(f"iter {it:4d} "
                  f"separation={separation(y.cpu().numpy(), labels_s):8.2f}")
    print(f"{args.iters} iterations in {time.time() - t0:.1f}s")
    sep = separation(y.cpu().numpy(), labels_s)
    assert sep > 5, "clusters failed to separate"
    print(f"final separation {sep:.1f}x — clusters separated OK")


if __name__ == "__main__":
    main()
