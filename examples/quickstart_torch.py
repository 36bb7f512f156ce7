"""Quickstart of the PyTorch/CUDA port: the paper's pipeline on a small
synthetic dataset — through the unified planner API only.

  python examples/quickstart_torch.py                 # on the GPU
  python examples/quickstart_torch.py --device cpu    # plain PyTorch paths

One call, ``repro_torch.api.build_plan``, runs the whole pipeline: kNN
interaction pattern (Eq. 1) -> PCA embedding + adaptive 2^d-tree ordering
(§2.4) -> two-level ELL-BSR storage -> γ-scored profile (§2.3). The plan
then serves the interaction ``y = A x`` through every registered SpMV
backend; here we compare orderings by γ (profile-only plans) and check
that all backends agree on the dual-tree plan. On a CUDA device the
``cuda`` backend is the hand-written kernel, built from source at first
use; on the CPU it is the kernel's plain version.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import api
from repro_torch.data.pipeline import feature_mixture


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    n, d, k = 2048, 128, 16
    x = feature_mixture(n, d, n_clusters=32, seed=0)
    print(f"dataset: {n} points in R^{d} (SIFT-like mixture)")

    print("\ngamma-score by ordering (higher = denser patches):")
    for name in api.ORDERINGS:
        profile = api.build_plan(x, k=k, ordering=name, with_bsr=False,
                                 device=args.device)
        print(f"  {name:10s} gamma = {profile.gamma:7.2f}")

    rng = np.random.default_rng(0)
    plan = api.build_plan(x, k=k, ordering="dual_tree", bs=32, sb=8,
                          backend="auto", device=args.device,
                          values=lambda r, c, d2: rng.random(len(r)))
    print(f"\ndual-tree plan: {plan}")
    print(f"  {plan.bsr.n_rb} row blocks, max {plan.bsr.max_nbr} tiles/row, "
          f"fill {plan.fill:.3f}")

    xvec = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x_sorted = plan.permute(xvec)
    results = {b: plan.apply(x_sorted, backend=b).cpu().numpy()
               for b in api.backend_names()}
    ref = results["csr"]
    print("\nSpMV backends vs csr (max-abs):")
    worst = 0.0
    for name, y in results.items():
        err = float(np.abs(y - ref).max())
        worst = max(worst, err)
        print(f"  {name:8s} {err:.2e}")
    assert worst <= 1e-4, f"backend disagreement {worst:.2e} > 1e-4"

    y = plan.unpermute(plan.apply(x_sorted))          # backend="auto"
    print(f"\nbackend='auto' resolved to {plan.resolve_backend()!r} on "
          f"{plan.device}; matvec norm {float(torch.linalg.norm(y)):.3f}")
    print("all backends agree OK")


if __name__ == "__main__":
    main()
