"""Analytic per-backend cost model + knob-based hardware config (the H100).

One model, two consumers in the port:

  * ``core.autotune`` ranks SpMV backends analytically (probes are demoted
    to one-off calibration of the model's constants), which is how a CPU
    plan's ``backend="auto"`` resolves; on a CUDA plan ``"auto"`` is the
    kernel, and the ranking is a report;
  * ``models.attention`` picks the plan-decode backend of ClusterKV
    (``decode_backend="auto"``) on a CPU tensor through
    :func:`choose_decode_backend`; on a CUDA tensor it is the kernel.

:func:`exchange_cost` prices a charge exchange over NVLink for the
sharded plans (``core.shardplan``), and ``backend_cost(.., "dist")`` the
sharded matvec. The reference's third consumer, the Pallas
tile sizing ``choose_tiles``, has no counterpart: the CUDA kernels fix
their launch shapes in ``kernels/csrc``.

The card is described by a handful of knobs (:class:`HardwareConfig`)
loadable from JSON — point ``REPRO_TORCH_HW_CONFIG`` at a knob file and
every decision re-derives from it without re-probing. A knob file written
for the reference's TPU knobs is refused (:meth:`HardwareConfig.from_dict`
names each TPU knob's counterpart here). Every report emitted here shares
one machine-readable envelope with the reference's: ``schema =
"repro.cost/v1"`` plus ``kind`` and the knobs that produced the numbers.

The formulas are the reference's (``src/repro/core/costmodel.py``), with
its ``pallas`` backend priced as the port's ``cuda`` kernel (B1/B2), which
reads only the kept ELL tiles and the charges once, and its decode
backends ``xla``/``pallas`` as ``plain``/``cuda`` with the launches the
port issues. The reference's ``interpret=True`` (a Pallas kernel run by
the interpreter on the CPU) becomes ``on_cpu=True``: a CPU tensor runs the
``cuda`` backends' plain versions, so ``cuda`` is not ranked there.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

SCHEMA = "repro.cost/v1"

# dense bottom tiles are float32 on every path (build_bsr casts)
_ELEM = 4.0
_IDX = 4.0

# The reference's TPU knobs and what stands for each here: a knob file
# written for the reference is refused with this map in the message.
_TPU_KNOBS = {
    "peak_flops": "fp32_flops (CUDA cores) and bf16_flops (tensor cores)",
    "link_bw": "nvlink_bw",
    "vmem_bytes": "smem_per_sm (no VMEM; the CUDA kernels fix their "
                  "shared-memory tiles in kernels/csrc)",
    "mxu_tile": "none (the tensor-core shape is the mma instruction's)",
    "interpret_penalty": "none (a CPU tensor runs the plain versions; "
                         "'cuda' is not ranked there)",
}

# Launches the plain plan-decode path (``core.clusterkv.plan_decode_plain``
# with the self column, float32 caches) issues on a CUDA tensor: every
# aten op it runs that computes on the device. Pinned by
# ``tests/test_torch_costmodel.py``, which counts them.
PLAIN_DECODE_LAUNCHES = 43
# B5 (``csrc/decode_attend.cu``): select, per-tile parts, combine
CUDA_DECODE_LAUNCHES = 3


@dataclass(frozen=True)
class HardwareConfig:
    """Knob-based description of the card (defaults: one NVIDIA H100 SXM).

    Data-sheet values (NVIDIA H100 SXM data sheet; CUDA C Programming
    Guide, compute capability 9.0) are marked so. ``hbm_bw`` (the achieved
    rate of a device copy), ``launch_overhead`` (host seconds per
    dispatched kernel, back to back), ``gather_penalty`` (a contiguous
    copy's rate over an irregular segment gather's, both counting bytes
    read and written) and ``edge_cost`` (seconds per scattered COO edge of
    the csr path's ``index_add_``) are probed by ``chip_smoke.py`` phase 14;
    their defaults are one such probe's values on an NVIDIA H100 80GB
    HBM3 at a 700.00 W power limit (``PERF.md`` §6). A knob no probe has
    measured says "uncalibrated".
    """
    name: str = "nvidia-h100-sxm"
    # data sheet, uncalibrated: float32 on the CUDA cores, bf16 on the
    # tensor cores (dense), NVLink 4 one way, shared memory per SM, L2
    fp32_flops: float = 67e12
    bf16_flops: float = 989e12
    nvlink_bw: float = 450e9
    smem_per_sm: int = 228 * 1024
    l2_bytes: int = 50 * 2 ** 20
    # data sheet; phase 14 installs the card's own SM count
    sm_count: int = 132
    # data sheet (the highest SM clock), uncalibrated; phase 1 prints the
    # card's clocks.max.sm
    sm_clock_hz: float = 1.98e9
    # programming guide (compute capability 9.0): ex2 a clock per SM on the
    # special-function units, B3's bound; uncalibrated
    ex2_per_clock_sm: int = 16
    # probed by chip_smoke.py phase 14 (NVIDIA H100 80GB HBM3, 700.00 W)
    hbm_bw: float = 3.0239e12        # achieved device copy, B/s
    launch_overhead: float = 8.852e-6    # host s per dispatched kernel
    gather_penalty: float = 7.268    # copy rate / segment-gather rate
    edge_cost: float = 1.4666e-11    # s per scattered COO edge

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "HardwareConfig":
        tpu = sorted(set(d) & set(_TPU_KNOBS))
        if tpu:
            names = "; ".join(f"{k} -> {_TPU_KNOBS[k]}" for k in tpu)
            raise ValueError(
                f"TPU knobs {tpu} belong to the reference's cost model; "
                f"the port's counterparts: {names}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown hardware knobs {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**dict(d))

    def to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "HardwareConfig":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


_HARDWARE: Optional[HardwareConfig] = None


def get_hardware() -> HardwareConfig:
    """The active hardware config: ``set_hardware``'s, else the JSON file
    named by ``REPRO_TORCH_HW_CONFIG``, else the built-in H100 knobs."""
    global _HARDWARE
    if _HARDWARE is None:
        path = os.environ.get("REPRO_TORCH_HW_CONFIG")
        _HARDWARE = (HardwareConfig.from_json(path) if path
                     else HardwareConfig())
    return _HARDWARE


def set_hardware(hw: "HardwareConfig | Mapping | str | None"
                 ) -> HardwareConfig:
    """Install a hardware config (object, knob dict, or JSON path).
    ``None`` resets to the environment default. Returns the active config.
    Decisions derived from the model (autotune winners) are re-evaluated
    lazily — clear the autotune memo to force new decisions."""
    global _HARDWARE
    if hw is None:
        _HARDWARE = None
        return get_hardware()
    if isinstance(hw, str):
        hw = HardwareConfig.from_json(hw)
    elif isinstance(hw, Mapping):
        hw = HardwareConfig.from_dict(hw)
    _HARDWARE = hw
    return hw


def make_report(kind: str, payload: Mapping,
                hw: Optional[HardwareConfig] = None) -> dict:
    """Shared machine-readable envelope for every cost report:
    ``{"schema", "kind", "hardware", **payload}``."""
    hw = hw or get_hardware()
    out = {"schema": SCHEMA, "kind": kind, "hardware": hw.to_dict()}
    out.update(payload)
    return out


# ---------------------------------------------------------------------------
# per-backend flops / bytes-accessed model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostFeatures:
    """Structural features of one SpMV problem.

    ``nnz`` is the *true* COO edge count when known (per member; the csr
    path's work), ``None`` falls back to every ELL slot full.
    ``kept_tiles`` is the number of kept ELL slots over the whole batch
    (``nbr_mask.sum()``): the ``cuda`` kernel reads only those tiles.
    ``None`` counts every slot as kept."""
    capacity: int
    bs: int
    sb: int
    n_rb: int
    n_cb: int
    max_nbr: int
    f: int = 1                     # charge feature columns
    batch: int = 1                 # stacked lanes (PlanBatch)
    nnz: Optional[int] = None      # true COO edges (csr path work)
    kept_tiles: Optional[int] = None   # kept ELL slots (cuda path work)


def plan_features(shape_key: Tuple[int, ...], f: int = 1,
                  batch: int = 1, nnz: Optional[int] = None,
                  kept_tiles: Optional[int] = None) -> CostFeatures:
    """``PlanSpec.shape_key`` -> :class:`CostFeatures`."""
    capacity, bs, sb, n_rb, n_cb, max_nbr = shape_key
    return CostFeatures(capacity=capacity, bs=bs, sb=sb, n_rb=n_rb,
                        n_cb=n_cb, max_nbr=int(max_nbr or 0), f=f,
                        batch=batch, nnz=nnz, kept_tiles=kept_tiles)


def spmv_kernel_bytes(kept_tiles: int, bs: int, col_idx_numel: int,
                      x_numel: int, y_numel: int) -> float:
    """Bytes the ``cuda`` SpMV kernel must move (each input read once,
    each output written once): every kept float32 tile, the int32
    ``col_idx``, the float32 charges and result: the count
    ``chip_smoke.spmv_bound`` states B1/B2's least time from (kept apart
    there, and held equal by ``tests/test_torch_costmodel.py``)."""
    return _ELEM * (kept_tiles * bs * bs + x_numel + y_numel) \
        + _IDX * col_idx_numel


def backend_cost(feat: CostFeatures, backend: str,
                 hw: Optional[HardwareConfig] = None, *, n_dev: int = 1,
                 exchange_blocks: int = 0) -> dict:
    """Closed-form flops / HBM bytes / seconds for one backend.

    The roofline estimate is ``max(flops/peak, bytes/hbm_bw)`` plus the
    per-launch overhead and (``dist`` only) the NVLink time of the halo
    exchange of ``exchange_blocks`` charge blocks over ``n_dev`` devices
    (the reference's formula, float32 at the CUDA-core peak). Absolute
    seconds are calibrated by the autotune (one probe per backend and
    device type, memoized); *relative* order across shapes and hardware
    configs is what the model owns.
    """
    hw = hw or get_hardware()
    B = feat.batch
    tiles = B * feat.n_rb * max(feat.max_nbr, 1)
    flops = 2.0 * tiles * feat.bs * feat.bs * feat.f
    tile_bytes = tiles * feat.bs * feat.bs * _ELEM
    seg_bytes = tiles * feat.bs * feat.f * _ELEM
    out_bytes = B * feat.n_rb * feat.bs * feat.f * _ELEM
    idx_bytes = tiles * _IDX
    link_bytes = 0.0
    launches = 1.0
    edge_s = 0.0
    if backend == "csr":
        # per-edge path over the TRUE nonzeros: each edge moves an index
        # pair and a value, and both the x-gather and the y-scatter-add
        # are irregular (penalized); the scatter-adds serialize per edge
        nnz = B * (feat.nnz if feat.nnz is not None
                   else feat.n_rb * max(feat.max_nbr, 1)
                   * feat.bs * feat.bs)
        flops = 2.0 * nnz * feat.f
        hbm = nnz * (_ELEM + 2 * _IDX) \
            + hw.gather_penalty * nnz * 2 * feat.f * _ELEM + out_bytes
        edge_s = nnz * hw.edge_cost
    elif backend == "bsr":
        # one flat path; the segment gather indexes the whole charge
        # vector (penalized: a gather runs far off the streaming roof)
        hbm = tile_bytes + hw.gather_penalty * seg_bytes + out_bytes \
            + idx_bytes
    elif backend == "bsr_ml":
        # superblock stripes keep each step's gather window small, so
        # segments stream at full bandwidth — paid for by one dispatched
        # step per stripe
        hbm = tile_bytes + seg_bytes + out_bytes + idx_bytes
        launches = float(max(-(-feat.n_rb // max(feat.sb, 1)), 1))
    elif backend == "cuda":
        # B1/B2: only the kept tiles cross HBM, each once; the charges are
        # read once (shared memory holds each segment a tile needs)
        kept = tiles if feat.kept_tiles is None else feat.kept_tiles
        flops = 2.0 * kept * feat.bs * feat.bs * feat.f
        hbm = spmv_kernel_bytes(kept, feat.bs, tiles,
                                B * feat.n_cb * feat.bs * feat.f,
                                B * feat.n_rb * feat.bs * feat.f)
    elif backend == "dist":
        # the reference's pricing: the flat path split over the devices,
        # plus the link time of the exchange
        hbm = (tile_bytes + hw.gather_penalty * seg_bytes + out_bytes) \
            / max(n_dev, 1)
        flops /= max(n_dev, 1)
        link_bytes = float(exchange_blocks) * feat.bs * _ELEM
    else:
        # unknown backends get the generic flat-path estimate
        hbm = tile_bytes + hw.gather_penalty * seg_bytes + out_bytes \
            + idx_bytes
    seconds = max(flops / hw.fp32_flops, hbm / hw.hbm_bw) \
        + launches * hw.launch_overhead + link_bytes / hw.nvlink_bw + edge_s
    return {"backend": backend, "flops": flops, "hbm_bytes": hbm,
            "link_bytes": link_bytes, "launches": launches,
            "seconds": seconds}


def rank_backends(feat: CostFeatures, names: Iterable[str], *,
                  hw: Optional[HardwareConfig] = None,
                  calibration: Optional[Mapping[str, float]] = None,
                  on_cpu: bool = False) -> dict:
    """Analytic ranking of ``names`` on ``feat`` — a machine-readable
    report (shared envelope) carrying the per-backend cost breakdown, the
    calibrated predicted seconds, and the ranking.

    ``calibration`` maps backend name -> measured/modeled ratio (from one
    probe, memoized by the autotune); missing backends rank with ratio
    1.0, non-finite ratios (probe failed) are excluded. ``on_cpu``: the
    problem's tensors lie on the CPU, where ``cuda`` runs its plain
    version, so ``cuda`` is not ranked.
    """
    hw = hw or get_hardware()
    calibration = calibration or {}
    costs: Dict[str, dict] = {}
    predicted: Dict[str, float] = {}
    for name in names:
        if on_cpu and name == "cuda":
            continue
        ratio = float(calibration.get(name, 1.0))
        if ratio != ratio or ratio == float("inf"):   # NaN or inf: excluded
            continue
        c = backend_cost(feat, name, hw)
        costs[name] = c
        predicted[name] = ratio * c["seconds"]
    ranking = sorted(predicted, key=predicted.get)
    return make_report("backend_rank", {
        "features": dataclasses.asdict(feat),
        "costs": costs,
        "calibration": {k: calibration.get(k) for k in predicted},
        "predicted_s": predicted,
        "ranking": ranking,
        "winner": ranking[0] if ranking else None,
    }, hw)


# ---------------------------------------------------------------------------
# iterative-solver pricing (repro_torch.solvers: CG on the plan matvec)
# ---------------------------------------------------------------------------


def _precond_cost(feat: CostFeatures, precond: str,
                  hw: HardwareConfig) -> Tuple[float, float, float, float]:
    """(setup_flops, setup_bytes, apply_flops, apply_bytes) of one
    preconditioner on one solve. Setup runs once per solve; apply runs
    every iteration."""
    B, f = feat.batch, feat.f
    vec = B * feat.capacity * f * _ELEM
    if precond == "block_jacobi":
        blocks = B * feat.n_rb
        # extraction reads every ELL tile once; Cholesky is bs^3/3 per
        # block; each apply is two triangular solves (bs^2 flops per rhs
        # column) streaming the factors
        setup_flops = blocks * feat.bs ** 3 / 3.0
        setup_bytes = B * feat.n_rb * max(feat.max_nbr, 1) \
            * feat.bs * feat.bs * _ELEM
        apply_flops = 2.0 * blocks * feat.bs ** 2 * f
        apply_bytes = blocks * feat.bs * feat.bs * _ELEM + 2 * vec
        return setup_flops, setup_bytes, apply_flops, apply_bytes
    if precond == "jacobi":
        setup_bytes = B * feat.n_rb * max(feat.max_nbr, 1) \
            * feat.bs * feat.bs * _ELEM        # diagonal still reads tiles
        return 0.0, setup_bytes, B * feat.capacity * f, 3 * vec
    # identity / unknown: free
    return 0.0, 0.0, 0.0, 0.0


def solver_cost(feat: CostFeatures, backend: str, *,
                iters: int, precond: str = "block_jacobi",
                hw: Optional[HardwareConfig] = None) -> dict:
    """Closed-form cost of one (batched) CG solve: ``setup + iters *
    per_iteration``.

    Per iteration: one backend matvec (:func:`backend_cost`), one
    preconditioner apply, and the CG vector work (~10 streamed vector
    passes). Setup: the preconditioner factorization. ``iters`` is the
    caller's estimate (telemetry from a prior solve, or a bound).
    """
    hw = hw or get_hardware()
    mv = backend_cost(feat, backend, hw)
    su_f, su_b, ap_f, ap_b = _precond_cost(feat, precond, hw)
    vec = feat.batch * feat.capacity * feat.f * _ELEM
    cg_bytes = 10.0 * vec                   # x/r/z/p updates + two dots
    cg_flops = 10.0 * feat.batch * feat.capacity * feat.f
    iter_s = mv["seconds"] \
        + max(ap_f / hw.fp32_flops, (ap_b + cg_bytes) / hw.hbm_bw)
    setup_s = max(su_f / hw.fp32_flops, su_b / hw.hbm_bw) \
        + hw.launch_overhead
    total = setup_s + iters * iter_s
    return {"backend": backend, "precond": precond, "iters": iters,
            "matvec": mv,
            "setup_flops": su_f, "setup_bytes": su_b,
            "iter_flops": mv["flops"] + ap_f + cg_flops,
            "iter_bytes": mv["hbm_bytes"] + ap_b + cg_bytes,
            "setup_seconds": setup_s, "iter_seconds": iter_s,
            "seconds": total}


def rank_solver_backends(feat: CostFeatures, names: Iterable[str], *,
                         iters: int, precond: str = "block_jacobi",
                         hw: Optional[HardwareConfig] = None,
                         calibration: Optional[Mapping[str, float]] = None,
                         on_cpu: bool = False) -> dict:
    """Analytic solver-backend ranking — the ``repro.cost/v1`` envelope,
    kind ``"solver_rank"``. The preconditioner and CG terms are
    backend-independent, so the induced ranking matches
    :func:`rank_backends` on the same features; what this report adds is
    absolute totals: setup amortization and the per-iteration floor the
    solver pays on top of the SpMV."""
    hw = hw or get_hardware()
    calibration = calibration or {}
    costs: Dict[str, dict] = {}
    predicted: Dict[str, float] = {}
    for name in names:
        if on_cpu and name == "cuda":
            continue
        ratio = float(calibration.get(name, 1.0))
        if ratio != ratio or ratio == float("inf"):
            continue
        c = solver_cost(feat, name, iters=iters, precond=precond, hw=hw)
        costs[name] = c
        predicted[name] = c["setup_seconds"] \
            + iters * (ratio * c["matvec"]["seconds"]
                       + c["iter_seconds"] - c["matvec"]["seconds"])
    ranking = sorted(predicted, key=predicted.get)
    return make_report("solver_rank", {
        "features": dataclasses.asdict(feat),
        "iters": iters,
        "precond": precond,
        "costs": costs,
        "calibration": {k: calibration.get(k) for k in predicted},
        "predicted_s": predicted,
        "ranking": ranking,
        "winner": ranking[0] if ranking else None,
    }, hw)


# ---------------------------------------------------------------------------
# decode-attention pricing (serve tick: models.attention decode backends)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodeFeatures:
    """Structural features of one plan-decode step (whole batch).

    ``s`` is the plan capacity (padded cache length), ``bk`` the tile
    edge, ``n_sel`` the top-c tiles attended per head. The work is
    identical across backends — what differs is how often the selected
    tiles cross HBM and how many launches a call pays."""
    batch: int
    hq: int
    hkv: int
    s: int
    dh: int
    dv: int
    bk: int
    n_sel: int


def decode_cost(feat: DecodeFeatures, backend: str,
                hw: Optional[HardwareConfig] = None) -> dict:
    """Closed-form flops / HBM bytes / seconds for one decode backend.

    Both paths score every centroid and attend the same ``n_sel * bk``
    selected rows per (member, kv head). The ``plain`` path gathers the
    selected tiles irregularly (``gather_penalty``), writes them back
    through HBM and reads them again to attend, in
    ``PLAIN_DECODE_LAUNCHES`` launches. The ``cuda`` kernel (B5) reads
    each selected tile once in ``CUDA_DECODE_LAUNCHES`` launches. A call
    is host-bound on the card, so ``launch_overhead`` decides.
    """
    hw = hw or get_hardware()
    bh = feat.batch * feat.hkv
    nkb = max(feat.s // max(feat.bk, 1), 1)
    sel_rows = bh * feat.n_sel * feat.bk
    sel_bytes = sel_rows * (feat.dh + feat.dv) * _ELEM
    cent_bytes = bh * nkb * feat.dh * _ELEM
    ps_bytes = bh * feat.s * _IDX
    q_bytes = feat.batch * feat.hq * feat.dh * _ELEM
    out_bytes = feat.batch * feat.hq * feat.dv * _ELEM
    flops = 2.0 * bh * nkb * feat.dh \
        + 2.0 * feat.batch * feat.hq * feat.n_sel * feat.bk \
        * (feat.dh + feat.dv)
    base = cent_bytes + ps_bytes + q_bytes + out_bytes
    if backend == "cuda":
        hbm = base + sel_bytes
        launches = float(CUDA_DECODE_LAUNCHES)
    else:
        # gather round-trip: irregular read, HBM write-back of the
        # gathered tiles, then the attend streams them back in
        hbm = base + hw.gather_penalty * sel_bytes + 2 * sel_bytes
        launches = float(PLAIN_DECODE_LAUNCHES)
    seconds = max(flops / hw.fp32_flops, hbm / hw.hbm_bw) \
        + launches * hw.launch_overhead
    return {"backend": backend, "flops": flops, "hbm_bytes": hbm,
            "launches": launches, "seconds": seconds}


def rank_decode_backends(feat: DecodeFeatures,
                         names: Iterable[str] = ("plain", "cuda"), *,
                         hw: Optional[HardwareConfig] = None,
                         on_cpu: bool = False) -> dict:
    """Analytic ranking of decode backends on ``feat`` — the same
    ``repro.cost/v1`` envelope as :func:`rank_backends`. ``on_cpu``:
    ``cuda`` runs its plain version there and is not ranked."""
    hw = hw or get_hardware()
    costs: Dict[str, dict] = {}
    predicted: Dict[str, float] = {}
    for name in names:
        if on_cpu and name == "cuda":
            continue
        c = decode_cost(feat, name, hw)
        costs[name] = c
        predicted[name] = c["seconds"]
    ranking = sorted(predicted, key=predicted.get)
    return make_report("decode_rank", {
        "features": dataclasses.asdict(feat),
        "costs": costs,
        "predicted_s": predicted,
        "ranking": ranking,
        "winner": ranking[0] if ranking else None,
    }, hw)


_DECODE_CHOICE: Dict[Tuple, str] = {}


def choose_decode_backend(feat: DecodeFeatures, *, on_cpu: bool = False,
                          hw: Optional[HardwareConfig] = None) -> str:
    """The model's winner for one decode shape, memoized per (shape,
    device kind, hardware) — the service asks every layer of every tick
    and the answer must not cost a ranking each time."""
    hw = hw or get_hardware()
    key = (feat, bool(on_cpu), hw)
    got = _DECODE_CHOICE.get(key)
    if got is None:
        got = rank_decode_backends(feat, hw=hw, on_cpu=on_cpu)["winner"]
        _DECODE_CHOICE[key] = got
    return got


# ---------------------------------------------------------------------------
# exchange pricing (the sharded plans of core.shardplan)
# ---------------------------------------------------------------------------


def exchange_cost(transfer_blocks: "int | None", bs: int,
                  hw: Optional[HardwareConfig] = None) -> Optional[float]:
    """Seconds to move ``transfer_blocks`` charge blocks of ``bs`` float32
    charges over NVLink (``None`` passes through — infeasible exchange
    candidates stay infeasible)."""
    if transfer_blocks is None:
        return None
    hw = hw or get_hardware()
    return float(transfer_blocks) * bs * _ELEM / hw.nvlink_bw
