"""Autotuning: SpMV backend selection for plans + attention budget tuning.

``tune_backend`` resolves ``backend="auto"`` for ``repro_torch.api`` plans
on the CPU (``tune_batch_backend`` for a ``PlanBatch``). The stopwatch
does not decide: backends are ranked by the analytic cost model's
predicted seconds on the plan's structural shape
(``core.costmodel.rank_backends``). Probes run only as *calibration* —
one measurement per backend and device type (memoized in ``_CALIB`` as
the measured/modeled ratio) — when a caller asks for a calibrated
ranking; ``"auto"`` itself ranks with the uncalibrated model, so the same
plan resolves the same way under any machine load. Decisions are
memoized on the plan's structural key with the full machine-readable
ranking report (``schema repro.cost/v1``); the memo is bounded, because
a streamed plan's edge count changes at every step.
``costmodel.set_hardware`` plus :func:`clear_tune_memo` re-decides
without re-probing.

Three rules differ from the reference's (``src/repro/core/autotune.py``):

* on a CUDA plan the winner is always ``cuda``: the kernel runs on card
  tensors, and the plans' ``"auto"`` resolves to it with no lookup and no
  host sync. There the ranking is a report (phase 14 of
  ``chip_smoke.py`` prints it), and the probes check the kernel: a
  ``cuda`` probe that raises, or disagrees with ``bsr`` beyond the
  agreement limit, raises out of the tune, where the reference would
  calibrate it to ``inf`` and rank a plain path. On the CPU ``cuda`` is
  not ranked (it would run its plain version);
* calibration is keyed by the device type as well as the backend: a plain
  backend timed on the CPU says nothing of the same backend on the card;
* agreement is relative: ``rtol x max|bsr|`` (1e-4 by default, the
  quickstart's bound), because the kernel and ``bsr`` sum in different
  orders and their float32 difference grows with the output's magnitude.

The attention-budget half below reuses the paper's γ-score idea to size
the cluster-sparse attention budget: after cluster-sorting keys, the
centroid score mass captured by the top-B key tiles per query tile is a
coverage estimate — pick the smallest B whose coverage reaches the target.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import from_numpy
from repro_torch.configs.base import ClusterKVConfig
from repro_torch.core import clusterkv as ckv
from repro_torch.core import costmodel
from repro_torch.core.registry import backend_names, get_backend
from repro_torch.launch.mesh import default_mesh

# structural memo of decisions, keyed by (shape_key, true nnz, charge ndim,
# backend set, calibrated, device type); values are the ranking reports.
# The oldest entry goes first once it holds _MEMO_MAX.
_TUNE_MEMO: Dict[tuple, dict] = {}
_MEMO_MAX = 256

# calibration constants: "<device type>:<name>" (or "<device
# type>:batch:<name>") -> measured / modeled seconds from ONE probe; inf
# marks a backend whose probe failed or disagreed
_CALIB: Dict[str, float] = {}


def clear_tune_memo() -> None:
    """Drop memoized auto-backend decisions (tests / fresh measurements).
    Calibration constants survive — re-decisions stay probe-free."""
    _TUNE_MEMO.clear()


def clear_calibration() -> None:
    """Drop probe calibration constants (forces fresh measurement)."""
    _CALIB.clear()


def _remember(key: tuple, report: dict) -> None:
    while len(_TUNE_MEMO) >= _MEMO_MAX:
        _TUNE_MEMO.pop(next(iter(_TUNE_MEMO)))
    _TUNE_MEMO[key] = report


def _ckey(dev_type: str, name: str, batch: bool = False) -> str:
    return f"{dev_type}:{'batch:' if batch else ''}{name}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _charges(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return from_numpy(np.random.default_rng(0).standard_normal(shape)
                      .astype(np.float32), device)


def _time(fn, device: torch.device, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _probe(run: Callable[[str], torch.Tensor], names: Iterable[str],
           device: torch.device, warmup: int, iters: int, rtol: float
           ) -> Tuple[Dict[str, float], Dict[str, Exception]]:
    """Median wall time (s) of ``run(name)`` for each backend that runs
    and agrees with ``run("bsr")`` within ``rtol x max|bsr|``; for each
    other backend, why it was skipped."""
    ref = run("bsr")
    scale = max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30)
    times: Dict[str, float] = {}
    skipped: Dict[str, Exception] = {}
    for name in names:
        try:
            y = run(name)
            _sync(device)
        except Exception as e:               # noqa: BLE001 — recorded
            skipped[name] = e
            continue
        err = float((y - ref).abs().max()) if ref.numel() else 0.0
        if tuple(y.shape) != tuple(ref.shape) or err > rtol * scale:
            skipped[name] = RuntimeError(
                f"backend {name!r} disagrees with 'bsr' on this plan: "
                f"max-abs {err:.3e} > {rtol:g} x scale")
            continue
        times[name] = _time(lambda: run(name), device, warmup, iters)
    return times, skipped


def probe_backends(plan, x: Optional[torch.Tensor] = None,
                   backends: Optional[Iterable[str]] = None,
                   warmup: int = 1, iters: int = 3,
                   rtol: float = 1e-4) -> Dict[str, float]:
    """Median wall time (s) per registered backend on the plan's shapes.

    A backend that raises (missing COO, ...) or disagrees with ``bsr``
    beyond ``rtol x max|bsr|`` is skipped — a fast-but-wrong backend must
    never win the autotune. On a CPU plan ``cuda`` is skipped: it would
    time its own plain version.
    """
    dev = plan.device
    if x is None:
        x = _charges((plan.n,), dev)
    names = tuple(backends) if backends is not None else backend_names()
    if dev.type != "cuda":
        names = tuple(n for n in names if n != "cuda")
    return _probe(lambda n: get_backend(n)(plan, x), names, dev, warmup,
                  iters, rtol)[0]


def _calibrate(names: Iterable[str], feat, run, device: torch.device,
               batch: bool = False, warmup: int = 1, iters: int = 3,
               rtol: float = 1e-4) -> None:
    """Probe every backend in ``names`` with no calibration constant yet
    for ``device``'s type and store measured/modeled ratios; a backend
    whose probe failed or disagreed calibrates to inf. On the card a
    ``cuda`` probe that fails raises instead."""
    dt = device.type
    missing = [n for n in names if _ckey(dt, n, batch) not in _CALIB]
    if not missing:
        return
    times, skipped = _probe(run, missing, device, warmup, iters, rtol)
    if dt == "cuda" and "cuda" in skipped:
        raise skipped["cuda"]
    for name in missing:
        meas = times.get(name)
        model_s = costmodel.backend_cost(feat, name)["seconds"]
        _CALIB[_ckey(dt, name, batch)] = (
            meas / model_s if meas is not None and model_s > 0
            else float("inf"))


def _rank_report(feat, names: Tuple[str, ...], device: torch.device,
                 calibrate: bool, batch: bool) -> dict:
    """The ranking report of ``names`` on ``feat`` (calibrated or not),
    its ``winner`` ``cuda`` on the card, else the ranking's first."""
    dt = device.type
    cal = ({n: _CALIB.get(_ckey(dt, n, batch), 1.0) for n in names}
           if calibrate else None)
    report = costmodel.rank_backends(feat, names, calibration=cal,
                                     on_cpu=dt != "cuda")
    if dt == "cuda" and "cuda" in names:
        winner = "cuda"                  # the kernel runs on card tensors
    else:
        winner = report["winner"] or "bsr"
    return dict(report, winner=winner)


def _rank(key: tuple, feat, names: Tuple[str, ...], device: torch.device,
          calibrate: bool, batch: bool) -> Tuple[str, Dict[str, float]]:
    """Rank ``names`` on ``feat``, memoize the report under ``key`` and
    return the winner (see :func:`_rank_report`)."""
    report = _rank_report(feat, names, device, calibrate, batch)
    _remember(key, report)
    return report["winner"], dict(report["predicted_s"])


def _with_dist(report: dict, plan, feat, ndev: int, dt: str) -> dict:
    """The reference's multi-device rule on top of a local ranking:
    ``dist`` wins when it calibrated healthy and the exchange model prices
    the plan's analyzed halo strictly under replication over ``ndev``
    devices. The report names the mesh the ``dist`` probe ran on."""
    from repro_torch.core.shardplan import analyze_shards

    ratio = _CALIB.get(_ckey(dt, "dist"), float("inf"))
    if ratio == float("inf"):
        return report
    spec, _ = analyze_shards(plan.bsr, ndev)
    halo_s = costmodel.exchange_cost(spec.transfer_blocks, plan.bsr.bs)
    ag_s = costmodel.exchange_cost(spec.allgather_blocks, plan.bsr.bs)
    if not halo_s < ag_s:
        return report
    dist_s = costmodel.backend_cost(
        feat, "dist", n_dev=ndev,
        exchange_blocks=spec.transfer_blocks)["seconds"]
    times = dict(report["predicted_s"], dist=ratio * dist_s)
    probe_mesh = default_mesh(device=dt).devices_along("data")
    return dict(report, winner="dist", predicted_s=times,
                dist={"n_dev": ndev, "mode": spec.mode,
                      "transfer_blocks": spec.transfer_blocks,
                      "allgather_blocks": spec.allgather_blocks,
                      "probe_mesh": [str(d) for d in probe_mesh]})


def tune_backend(plan, x: Optional[torch.Tensor] = None,
                 backends: Optional[Iterable[str]] = None,
                 device_count: Optional[int] = None,
                 calibrate: bool = True
                 ) -> Tuple[str, Dict[str, float]]:
    """Rank the backends for ``plan`` with the analytic model.

    Returns ``(name, predicted seconds per backend)``. On a CPU plan the
    winner is the argmin of the returned dict and ``cuda`` is not ranked;
    on a CUDA plan it is ``cuda`` whatever the ranking says. A
    profile-only plan (no storage) gives ``"bsr"``, whose ``apply`` says
    why it cannot run.

    ``calibrate=True`` (the reference's behaviour) times each backend the
    first time it is seen on a device type and scales its prediction by
    the measured/modeled ratio (``_CALIB``); on the card that probe also
    checks the kernel against ``bsr`` and raises if it fails.
    ``calibrate=False`` ranks with the model alone: what a CPU plan's
    ``"auto"`` asks, so the same plan resolves the same way under any
    load. Decisions are memoized on ``(shape_key, true nnz, charge ndim,
    backend set, calibrate, device type)`` with their ranking reports; a
    miss reads the plan's kept-tile count once.

    Device-count-aware, as the reference: ``device_count`` (default: the
    CUDA devices for a CUDA plan, 1 for a CPU plan) of 2 or more lets the
    sharded ``dist`` backend win whenever it calibrated healthy and the
    exchange model prices the plan's analyzed halo (``analyze_shards``
    over ``device_count`` devices) strictly under replication; ``dist``
    then appears in the returned dict and the report records the mesh its
    probe ran on (``default_mesh()``: on a one-card machine, that card).
    Multi-device decisions are not reused: their reports are kept in the
    memo under the key plus the device count, for reading only.
    """
    names = tuple(backends) if backends is not None else backend_names()
    if plan.bsr is None:
        return "bsr", {}
    dev = plan.device
    ndev = (device_count if device_count is not None
            else torch.cuda.device_count() if dev.type == "cuda" else 1)
    local = tuple(n for n in names if n != "dist"
                  and not (n == "cuda" and dev.type != "cuda"))
    ndim = x.ndim if x is not None else 1
    coo = plan.host.coo
    nnz = int(len(coo[0])) if coo is not None else None
    key = (plan.spec.shape_key, nnz, ndim, local, calibrate, dev.type)
    if ndev < 2:
        hit = _TUNE_MEMO.get(key)
        if hit is not None:
            return hit["winner"], dict(hit["predicted_s"])
    f = x.shape[-1] if (x is not None and x.ndim == 2) else 1
    feat = costmodel.plan_features(plan.spec.shape_key, f=f, nnz=nnz,
                                   kept_tiles=int(plan.bsr.nbr_mask.sum()))
    multi = ndev >= 2 and "dist" in names
    if calibrate or multi:
        xp = x if x is not None else _charges((plan.n,), dev)

        def run(n):
            return get_backend(n)(plan, xp)

        if calibrate:
            _calibrate(local, feat, run, dev)
        if multi:
            # dist needs a mesh to calibrate (the default one); a failed
            # probe marks it non-viable here
            _calibrate(("dist",), feat, run, dev)
    if ndev < 2:
        return _rank(key, feat, local, dev, calibrate, batch=False)
    report = _rank_report(feat, local, dev, calibrate, batch=False)
    if multi:
        report = _with_dist(report, plan, feat, ndev, dev.type)
    _remember(key + (ndev,), report)
    return report["winner"], dict(report["predicted_s"])


def tune_batch_backend(batch, x: Optional[torch.Tensor] = None,
                       backends: Optional[Iterable[str]] = None,
                       warmup: int = 1, iters: int = 3,
                       rtol: float = 1e-4, calibrate: bool = True
                       ) -> Tuple[str, Dict[str, float]]:
    """One shared backend decision for a whole ``api.PlanBatch``.

    Same shape as :func:`tune_backend`, but calibration runs the
    *batched* call itself (``api._batch_apply``) — batching changes the
    gather shapes and the launch count, so batch backends calibrate under
    ``"<device type>:batch:<name>"`` keys. A profile-only batch gives
    ``"bsr"``, whose call says why it cannot run. Memoized on ``(batch
    shape_key, B, charge ndim, backend set, calibrate, device type)``:
    spec-identical batches — every construction in a serving loop — tune
    once.
    """
    from repro_torch import api

    if batch.spec.max_nbr is None:
        return "bsr", {}
    dev = batch.device
    names = (tuple(backends) if backends is not None
             else tuple(n for n in api._BATCHED_BACKENDS
                        if n in backend_names()))
    if dev.type != "cuda":
        names = tuple(n for n in names if n != "cuda")
    ndim = (x.ndim - 1) if x is not None else 1
    key = ("batch", batch.spec.shape_key, batch.batch, ndim, names,
           calibrate, dev.type)
    hit = _TUNE_MEMO.get(key)
    if hit is not None:
        return hit["winner"], dict(hit["predicted_s"])
    f = x.shape[-1] if (x is not None and x.ndim == 3) else 1
    feat = costmodel.plan_features(
        batch.spec.shape_key, f=f, batch=batch.batch,
        kept_tiles=int(batch.data.nbr_mask.sum()))
    if calibrate:
        xs = (x if x is not None
              else _charges((batch.batch, batch.capacity), dev))
        _calibrate(names, feat,
                   lambda n: api._batch_apply(batch.spec, batch.data, xs, n,
                                              "apply", serial=False),
                   dev, batch=True, warmup=warmup, iters=iters, rtol=rtol)
    return _rank(key, feat, names, dev, calibrate, batch=True)


def coverage_curve(q: torch.Tensor, k: torch.Tensor,
                   cfg: ClusterKVConfig) -> torch.Tensor:
    """Estimated softmax-mass coverage as a function of B (tiles kept).

    q (B,Hq,S,dh), k (B,Hkv,S,dh). Returns (nkb,) monotone curve: entry i =
    mean over query tiles of the softmax mass (at tile granularity)
    captured by the top-(i+1) key tiles under the cluster ordering.
    """
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    bq = min(cfg.block_q, s)
    bk = min(cfg.block_k, s)
    nqb = s // bq

    perm = ckv.cluster_perm(k, d=cfg.embed_dim)
    k_s = torch.gather(k, -2, perm[..., None].expand(tuple(k.shape)))
    cent = ckv.block_centroids(k_s, bk)                    # (B,Hkv,nkb,dh)
    qc = q.reshape(b, hkv, hq // hkv, nqb, bq, dh).mean(dim=(2, 4))
    scores = torch.einsum("bhqd,bhkd->bhqk", qc.float(),
                          cent.float()) / float(dh) ** 0.5
    # tile-granularity softmax mass, sorted descending per query tile
    w = torch.softmax(scores * bk, dim=-1)     # bk: tiles hold bk keys
    w_sorted = -torch.sort(-w, dim=-1).values
    return torch.cumsum(w_sorted, dim=-1).mean(dim=(0, 1, 2))


def tune_blocks_per_query(q: torch.Tensor, k: torch.Tensor,
                          cfg: ClusterKVConfig,
                          target_coverage: float = 0.95
                          ) -> Tuple[ClusterKVConfig, float]:
    """Smallest B reaching the target estimated coverage (plus the always-
    kept local window). Returns (updated config, achieved coverage)."""
    curve = coverage_curve(q, k, cfg)
    nkb = curve.shape[0]
    b_needed = int(torch.argmax((curve >= target_coverage).to(torch.int32))
                   ) + 1
    if float(curve[-1]) < target_coverage:
        b_needed = nkb
    b_needed = min(b_needed + cfg.local_window_blocks, nkb)
    return (dataclasses.replace(cfg, blocks_per_query=b_needed),
            float(curve[min(b_needed, nkb) - 1]))
