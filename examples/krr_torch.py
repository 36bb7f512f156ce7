"""Kernel ridge regression through the plan operator on the PyTorch/CUDA
port: the twin of ``examples/krr.py``.

  python examples/krr_torch.py [--n 2048]                 # on the GPU
  python examples/krr_torch.py --device cpu               # plain paths

Fits ``(K + lam*I) alpha = y`` where ``K`` is the RBF kernel truncated to
the plan's symmetrized kNN pattern — the solver never sees a matrix, only
``plan.apply`` with the regularized diagonal folded in (on the GPU one
launch of the hand-written SpMV kernel per CG iteration). Preconditioned
CG (block-Jacobi from the plan's own diagonal BSR tiles) carries the
solve; the fitted model predicts in-sample and at held-out points through
the kNN-truncated cross kernel.

On small problems the script also checks the matrix-free fit against a
dense ``scipy.linalg.solve`` of the very same truncated kernel, and ends
with "OK".
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
from repro_torch.solvers import RBFValues, krr_fit


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--dense-check", type=int, default=2048,
                    help="dense-reference check up to this n (0 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    x = feature_mixture(args.n + 256, args.d, n_clusters=16, seed=0)
    x_train, x_test = x[:args.n], x[args.n:]
    w_true = rng.standard_normal(args.d).astype(np.float32)
    y = np.tanh(x @ w_true).astype(np.float32)
    y_train, y_test = y[:args.n], y[args.n:]

    plan = api.build_plan(x_train, k=args.k, bs=32, sb=8, backend="auto",
                          symmetrize=True, values=RBFValues(),
                          device=args.device)
    print(f"plan: {plan} (solver backend {plan.resolve_backend()!r})")

    t0 = time.perf_counter()
    model = krr_fit(plan, y_train, lam=args.lam)
    if plan.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = model.result
    print(f"fit: {int(res.iters)} CG iterations "
          f"({'converged' if bool(res.converged) else 'NOT converged'}, "
          f"final rel resid {float(res.resid / res.bnorm):.2e}) "
          f"in {t1 - t0:.3f}s")

    yhat = model.predict().cpu().numpy()
    in_mse = float(np.mean((yhat - y_train) ** 2))
    yhat_t = model.predict(x_test).cpu().numpy()
    out_mse = float(np.mean((yhat_t - y_test) ** 2))
    base = float(np.mean((y_test - y_train.mean()) ** 2))
    print(f"train mse {in_mse:.4f} | test mse {out_mse:.4f} "
          f"(predict-the-mean baseline {base:.4f})")

    if args.dense_check and args.n <= args.dense_check:
        from scipy.linalg import solve as dense_solve
        dense = plan.bsr.to_dense()
        # Gershgorin self weight (auto) + regularizer
        shift = float(model.self_weight) + args.lam
        alpha_ref = dense_solve(
            dense + shift * np.eye(plan.n), y_train[plan.host.pi],
            assume_a="sym")[plan.host.inv]
        alpha = model.alpha.cpu().numpy()
        err = np.abs(alpha - alpha_ref).max() / np.abs(alpha_ref).max()
        print(f"dense scipy reference: max rel err {err:.2e}")
        assert err < 1e-3, "matrix-free fit disagrees with dense reference"
    print("OK")


if __name__ == "__main__":
    main()
