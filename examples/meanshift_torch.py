"""Mean shift through the PyTorch/CUDA port (paper §3.2): the twin of
``examples/meanshift.py``. Targets shift iteratively towards the
kernel-weighted mean of their neighbors in a fixed source set — the
non-stationary interaction case, driven through the plan lifecycle: one
``build_plan`` up front, then ``plan.refresh`` in the inner loop, whose
policy decides per step whether the moved targets need an in-place
pattern patch, a stable partial re-bucket or a full rebuild.

  python examples/meanshift_torch.py [--iters 30]        # on the GPU
  python examples/meanshift_torch.py --device cpu        # plain paths

The run ends with "converged to modes OK".
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
from scipy.cluster.vq import kmeans2

from repro_torch import api


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    n, d, k = 1024, 32, 32
    rng = np.random.default_rng(2)
    basis = rng.standard_normal((6, d)) / np.sqrt(6)
    centers = rng.standard_normal((6, 6)) @ basis * 4.0
    labels = rng.integers(0, 6, n)
    src = (centers[labels] + 0.4 * rng.standard_normal((n, d))
           ).astype(np.float32)
    t = src.copy()                      # targets start at the points
    h2 = 2.0

    # one plan for the whole run: kNN of the (moving) targets among the
    # fixed sources, dual-tree ordered, with ELL slack so migrated rows
    # can gain neighbor tiles in place
    plan = api.build_plan(t, k=k, sources=src, bs=32, ell_slack=2,
                          device=args.device)
    print(f"initial {plan}")

    t0 = time.time()
    for it in range(args.iters):
        if it:
            plan = plan.refresh(t)
        t_s = plan.permute(t)
        src_s = plan.permute(src)
        t = plan.unpermute(
            plan.meanshift_step(t_s, src_s, h2).cpu().numpy())
    dt = time.time() - t0
    st = plan.refresh_stats
    print(f"{args.iters} mean-shift iterations in {dt:.1f}s — refreshes: "
          f"{st.patches} patched ({st.patched_rows} rows), "
          f"{st.rebuckets} re-bucketed, {st.rebuilds} rebuilt")
    print(f"final γ drift vs lineage reference: {plan.gamma_drift():+.3f}")

    # targets should have collapsed near the 6 modes
    modes, assign = kmeans2(t, 6, seed=0, minit="++")
    spread = np.mean([t[assign == c].std(0).mean() for c in range(6)
                      if (assign == c).any()])
    print(f"residual intra-mode spread: {spread:.4f} (start ~0.4)")
    assert spread < 0.1, "mean shift failed to converge to modes"
    print("converged to modes OK")


if __name__ == "__main__":
    main()
