"""What the interaction-plan cells share: the deployment's points, the plan
built as the configuration states, and the comparison of the plan's
products with the plain reference (``reference/knn.py``)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.harness import gen
from perfbench.reference import knn as ref_knn


class GaussianValues:
    """The plan's edge values ``exp(-d2 / h)`` from the kNN's squared
    distances (the callable ``api.build_plan(values=...)`` takes)."""

    def __init__(self, bandwidth: float):
        self.bandwidth = float(bandwidth)

    def __call__(self, rows, cols, d2):
        return np.exp(-np.asarray(d2, np.float64) / self.bandwidth
                      ).astype(np.float32)


def points(cfg: Dict[str, Any], index: int) -> np.ndarray:
    """Point set ``index`` of the deployment's data (``data_seed``; the
    same in every run): (n, D) float32 on the host."""
    return gen.feature_mixture(cfg["n_points"], cfg["dim"],
                               cfg["n_clusters"],
                               gen.sub_seed(cfg["data_seed"], 1, index),
                               cfg["spread"])


def build(cfg: Dict[str, Any], x: np.ndarray, device, values=None):
    """``api.build_plan`` as the configuration states it, from host
    points (as users hand them over)."""
    from repro_torch import api
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the configuration states float32 with TF32 off")
    return api.build_plan(
        x, k=cfg["k_neighbors"], ordering=cfg["ordering"], bs=cfg["tile"],
        sb=cfg["superblock"], d=cfg["embed_dim"], bits=cfg["morton_bits"],
        leaf_size=cfg["leaf_size"], backend="auto",
        values=values or GaussianValues(cfg["bandwidth"]), device=device)


def storage_counts(plan) -> Dict[str, int]:
    """The plan's storage as B1 walks it (program counters)."""
    b = plan.bsr
    return {"kept_tiles": int(b.nbr_mask.sum()), "bs": int(b.bs),
            "n_rb": int(b.n_rb), "max_nbr": int(b.max_nbr), "n": int(plan.n)}


def sample_rows(cfg: Dict[str, Any], traffic: Dict[str, Any],
                x: torch.Tensor, seed: int, tag: int) -> torch.Tensor:
    """Rows drawn from the seed that are no near tie (``reference/knn``)."""
    want = traffic["sample_rows"]
    cand = torch.as_tensor(gen.sample(seed, tag, x.shape[0], 3 * want),
                           device=x.device)
    rows = ref_knn.checkable(x, cand, cfg["k_neighbors"], cfg["tie_rel"],
                             want)
    if rows.numel() < want:
        raise RuntimeError(f"only {rows.numel()} of {cand.numel()} rows drawn "
                           f"are no near tie; {want} wanted")
    return rows


def compare(cfg: Dict[str, Any], x: torch.Tensor, rows: torch.Tensor,
            answers: List[torch.Tensor], charges: List[torch.Tensor],
            tf32: bool = False) -> List[float]:
    """The relative gap of each answer (the program's product at ``rows``)
    against the reference's product with its charges; with ``tf32`` the
    control's product takes the answers' place."""
    k, h = cfg["k_neighbors"], cfg["bandwidth"]
    idx, d2, _, _ = ref_knn.neighbors(x, rows, k)
    if tf32:
        cidx, cd2, _, _ = ref_knn.neighbors(x, rows, k, tf32=True)
    out = []
    for y, ch in zip(answers, charges):
        ch = ch.to(x.device)
        got = ref_knn.product_rows(cidx, cd2, ch, h) if tf32 else y
        out.append(ref_knn.rel_error(got.to(x.device),
                                     ref_knn.product_rows(idx, d2, ch, h)))
    return out
