"""Streaming point sets through the PyTorch/CUDA port: the twin of
``examples/stream.py``. One ``InteractionPlan`` serves a feed of arrivals
and retirements through the streaming tiers:

  tombstone   deletes flip the row-validity mask and re-dress only the
              row-blocks that referenced the dead points (broken edges
              are routed around the tombstone to the dead point's own
              surviving neighbors)
  append      inserts re-embed through the stored PCA map, claim the
              free slot nearest their Morton leaf, and land as row-block
              patches; rows whose kNN the arrival enters adopt it
  rebucket    a γ-drift guard re-sorts the slots by their maintained
              Morton codes when displaced inserts decay the ordering
  restripe    an ELL overflow re-dresses the storage from the maintained
              COO at the kept ordering
  compact     dead capacity beyond PlanConfig.max_dead_frac triggers the
              full rebuild on the survivors — bit-exact with build_plan

  python examples/stream_torch.py [--steps 20]            # on the GPU
  python examples/stream_torch.py --device cpu --n 2048   # plain paths

Per step the plan serves a matvec; at the end the streamed plan is
compared against a from-scratch build on the surviving points, and the
run ends with "streamed plan OK".
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import api
from repro_torch.data.pipeline import feature_mixture


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--churn", type=float, default=0.02,
                    help="fraction of points replaced per step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    n, d, k = args.n, 64, 16
    m = max(int(n * args.churn), 1)
    rng = np.random.default_rng(0)
    pool = feature_mixture(n + args.steps * m, d, n_clusters=16, seed=0)

    plan = api.build_plan(pool[:n], k=k, bs=32, sb=8, backend="auto",
                          ell_slack=4, capacity=int(n * 1.1),
                          device=args.device)
    _ = plan.gamma                      # arm the γ-drift rebucket guard
    print(f"built {plan}")

    feed = n
    charges = rng.standard_normal(plan.n).astype(np.float32)
    for step in range(args.steps):
        live = np.nonzero(plan.alive)[0]
        kill = rng.choice(live, m, replace=False)
        xin = pool[feed:feed + m]
        feed += m
        t0 = time.perf_counter()
        plan = api.update_plan(plan, insert=xin, delete=kill)
        dt = time.perf_counter() - t0
        if len(charges) != plan.n:      # capacity grew / plan compacted
            charges = np.resize(charges, plan.n)
        y = plan.matvec(charges)
        st = plan.refresh_stats
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}: {st.last_action:9s} {dt*1e3:6.1f}ms  "
                  f"n={plan.n_alive}/cap={plan.capacity} "
                  f"dead={plan.dead_frac:.3f} |y|="
                  f"{float(torch.linalg.norm(y)):.2f}")

    st = plan.refresh_stats
    print(f"\ntier telemetry after {args.steps} steps of "
          f"{2 * args.churn:.0%} churn:")
    print(f"  appends={st.appends} tombstones={st.tombstones} "
          f"rebuckets={st.rebuckets} restripes={st.restripes} "
          f"compactions={st.compactions} grows={st.grows}")
    print(f"  inserted={st.inserted_total} deleted={st.deleted_total}")

    fresh = api.build_plan(plan.host.x[plan.alive], config=plan.config,
                           device=plan.device)
    ratio = plan.gamma / fresh.gamma
    print(f"  streamed gamma {plan.gamma:.3f} vs fresh build "
          f"{fresh.gamma:.3f} (ratio {ratio:.3f})")
    assert 0.9 <= ratio <= 1.1, "streamed locality decayed"

    compacted = plan.compact()
    xv = rng.standard_normal(compacted.n).astype(np.float32)
    assert torch.equal(compacted.matvec(xv), fresh.matvec(xv)), \
        "compact must equal a fresh build"
    print(f"  compact == fresh build on survivors (bit-exact), "
          f"{compacted}")
    print("streamed plan OK")


if __name__ == "__main__":
    main()
