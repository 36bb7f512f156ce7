"""Sharded plans: per-device row-block BSR shards with halo exchange.

``shard(plan, mesh)`` transforms an :class:`repro_torch.api.InteractionPlan`
into a :class:`ShardedPlan` whose row-blocks are partitioned contiguously
over a mesh axis — the paper's parallel SpMV, which splits the row blocks
over threads, with the threads replaced by devices. Because the cluster
ordering makes every row-block's column footprint compact (§2.4 step 2),
the charge window each device needs is its *own* charge shard plus a small
**halo** of neighbouring blocks. The halo is computed exactly from the ELL
schedule (``col_idx`` under ``nbr_mask``), so on banded/clustered patterns
each matvec moves only the halo blocks between neighbour devices instead of
all-gathering the full charge vector.

Exchange modes, chosen per plan by :func:`analyze_shards`:

  halo       left/right halos (each capped at one shard) from the cyclic
             neighbours, plus an optional **hot set**: the few column
             blocks referenced from outside any window (stray
             cross-cluster kNN edges), replicated to every device by a
             scatter on each owner and a sum of the buffers
  ring       a dense band wider than one shard: whole neighbour shards
             fetched hop by hop
  allgather  scattered patterns with near-global support: every shard

The host analysis and the window-local column remap are the reference's
(``src/repro/core/shardplan.py``), in numpy. The mesh is the port's
single-controller :class:`~repro_torch.launch.mesh.Mesh`: where the
reference runs ``ppermute``/``all_gather``/``psum`` inside ``shard_map``,
:meth:`ShardedPlan.apply` performs the same exchange with copies between
the mesh devices (``tensor.to(device)``) and concatenations, then runs
each shard's window through the SpMV kernel B2
(``kernels/bsr_spmv.bsr_spmv``) with the shard's slot mask — one launch per
shard per apply on a card, the plain einsum on the CPU. The local operator
is rectangular: ``rb_per`` row blocks against ``win + n_hot`` column
blocks.

Lifecycle: ``refresh``/``update``/``absorb`` compose with the plan
lifecycle. A layout-preserving tier (patch, append, tombstone) writes only
into clones of the shards owning the touched row-blocks (ROADMAP C6: the
input ``ShardedPlan`` stays valid, untouched shards keep their tensors);
everything else re-shards the new plan on the same mesh.

Charges are 1-D, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import from_numpy, to_numpy
from repro_torch.core import costmodel
from repro_torch.core.blocksparse import BSR
from repro_torch.kernels import bsr_spmv as _bsr
from repro_torch.launch.mesh import Mesh, default_mesh

__all__ = ["ShardSpec", "ShardedPlan", "analyze_shards", "shard",
           "default_mesh"]


@dataclass(frozen=True)
class ShardSpec:
    """Host-side halo analysis of a BSR over an ``n_dev``-way row split.

    All quantities are in *column-block* units (one block = ``bs``
    charges). ``transfer_blocks`` is the number of charge blocks each
    device receives per matvec — the quantity the halo exchange minimizes
    (replication via all-gather costs ``(n_dev - 1) * rb_per``). Hot-set
    blocks are billed at 2x: the replication both sends and receives each
    contribution.
    """
    axis: str
    n_dev: int
    rb_per: int            # row-blocks owned per device (after padding)
    n_rb_pad: int          # rb_per * n_dev
    halo_lo: int           # left-halo width (max over devices, <= rb_per)
    halo_hi: int           # right-halo width (max over devices, <= rb_per)
    hops_lo: int           # whole-shard hops left (ring mode)
    hops_hi: int           # whole-shard hops right (ring mode)
    n_hot: int             # replicated out-of-window column blocks
    mode: str              # halo | ring | allgather
    win: int               # halo-window length per device, in blocks

    @property
    def transfer_blocks(self) -> int:
        if self.mode == "halo":
            return self.halo_lo + self.halo_hi + 2 * self.n_hot
        if self.mode == "ring":
            return (self.hops_lo + self.hops_hi) * self.rb_per
        return (self.n_dev - 1) * self.rb_per

    @property
    def allgather_blocks(self) -> int:
        return (self.n_dev - 1) * self.rb_per

    def window_base(self, dev: int) -> int:
        """First global column-block of device ``dev``'s halo window."""
        if self.mode == "halo":
            return dev * self.rb_per - self.halo_lo
        if self.mode == "ring":
            return (dev - self.hops_lo) * self.rb_per
        return 0


def _support(bsr: BSR, rb_per: int, n_dev: int):
    """Per-device sorted unique column support from the ELL schedule."""
    out = []
    for d in range(n_dev):
        r0, r1 = d * rb_per, min((d + 1) * rb_per, bsr.n_rb)
        out.append(bsr.rowblock_cols(r0, r1) if r0 < r1
                   else np.empty(0, np.int64))
    return out


def analyze_shards(bsr: BSR, n_dev: int, axis: str = "data"
                   ) -> Tuple[ShardSpec, np.ndarray]:
    """Exchange plan for ``bsr`` row-sharded ``n_dev`` ways.

    Reads the ELL schedule on the host and prices three covers of every
    device's column support — capped halo + replicated hot set,
    whole-shard ring hops, full all-gather — with the cost model's
    :func:`~repro_torch.core.costmodel.exchange_cost`, picking the
    cheapest. Returns ``(spec, hot)`` where ``hot`` is the sorted global
    column blocks of the hot set (empty outside halo mode).
    """
    n_rb = bsr.n_rb
    rb_per = -(-n_rb // n_dev)
    n_rb_pad = rb_per * n_dev
    no_hot = np.empty(0, np.int64)

    if n_dev == 1:
        return ShardSpec(axis=axis, n_dev=1, rb_per=rb_per,
                         n_rb_pad=n_rb_pad, halo_lo=0, halo_hi=0,
                         hops_lo=0, hops_hi=0, n_hot=0, mode="halo",
                         win=rb_per), no_hot

    support = _support(bsr, rb_per, n_dev)

    # candidate 1: halo capped at one shard per side + hot set for the rest
    halo_lo = halo_hi = 0
    far = []
    for d, cols in enumerate(support):
        if cols.size == 0:
            continue
        r0, r1 = d * rb_per, (d + 1) * rb_per
        near = cols[(cols >= r0 - rb_per) & (cols < r1 + rb_per)]
        far.append(cols[(cols < r0 - rb_per) | (cols >= r1 + rb_per)])
        if near.size:
            halo_lo = max(halo_lo, r0 - int(near.min()))
            halo_hi = max(halo_hi, int(near.max()) - (r1 - 1))
    halo_lo, halo_hi = max(halo_lo, 0), max(halo_hi, 0)
    hot = (np.unique(np.concatenate(far)) if far else no_hot
           ).astype(np.int64)
    blocks_halo = halo_lo + halo_hi + 2 * len(hot)

    # candidate 2: uncapped whole-shard ring hops (wide dense bands)
    span_lo = span_hi = 0
    for d, cols in enumerate(support):
        if cols.size == 0:
            continue
        r0, r1 = d * rb_per, (d + 1) * rb_per
        span_lo = max(span_lo, r0 - int(cols.min()))
        span_hi = max(span_hi, int(cols.max()) - (r1 - 1))
    hops_lo, hops_hi = -(-span_lo // rb_per), -(-span_hi // rb_per)
    ring_ok = hops_lo + hops_hi < n_dev - 1
    blocks_ring = (hops_lo + hops_hi) * rb_per if ring_ok else None

    blocks_ag = (n_dev - 1) * rb_per
    # the three candidates in seconds on the configured interconnect (a
    # monotone map of the block counts, so the decision is the block
    # compare)
    cost_halo = costmodel.exchange_cost(blocks_halo, bsr.bs)
    cost_ring = costmodel.exchange_cost(blocks_ring, bsr.bs)
    cost_ag = costmodel.exchange_cost(blocks_ag, bsr.bs)
    best = min(c for c in (cost_halo, cost_ring, cost_ag) if c is not None)
    if best == cost_halo and cost_halo < cost_ag:
        return ShardSpec(axis=axis, n_dev=n_dev, rb_per=rb_per,
                         n_rb_pad=n_rb_pad, halo_lo=halo_lo,
                         halo_hi=halo_hi, hops_lo=0, hops_hi=0,
                         n_hot=len(hot), mode="halo",
                         win=halo_lo + rb_per + halo_hi), hot
    if cost_ring is not None and best == cost_ring and cost_ring < cost_ag:
        return ShardSpec(axis=axis, n_dev=n_dev, rb_per=rb_per,
                         n_rb_pad=n_rb_pad, halo_lo=min(span_lo, rb_per),
                         halo_hi=min(span_hi, rb_per), hops_lo=hops_lo,
                         hops_hi=hops_hi, n_hot=0, mode="ring",
                         win=(hops_lo + 1 + hops_hi) * rb_per), no_hot
    return ShardSpec(axis=axis, n_dev=n_dev, rb_per=rb_per,
                     n_rb_pad=n_rb_pad, halo_lo=0, halo_hi=0, hops_lo=0,
                     hops_hi=0, n_hot=0, mode="allgather",
                     win=n_rb_pad), no_hot


def _row_bases(spec: ShardSpec, rows: np.ndarray) -> np.ndarray:
    """Window base of each row-block's owning device."""
    base = np.array([spec.window_base(d) for d in range(spec.n_dev)],
                    np.int64)
    return base[rows // spec.rb_per]


def _remap_cols(col: np.ndarray, mask: np.ndarray, base: np.ndarray,
                spec: ShardSpec, hot: np.ndarray):
    """Global column-blocks -> window-local slots, given per-row bases.

    Real columns inside the row's halo window map to ``col - base``; real
    columns outside it map to ``win + index-in-hot``. Padded slots (mask
    False) map to slot 0: the kernel skips them. Returns ``(local,
    covered)``: ``covered`` is False where a *real* column escapes both
    window and hot set (the incremental update uses it to detect overflow;
    at shard time the analysis guarantees full coverage).
    """
    local = col.astype(np.int64) - base[:, None]
    in_win = (local >= 0) & (local < spec.win)
    if spec.n_hot:
        pos = np.searchsorted(hot, col)
        in_hot = (pos < spec.n_hot) & (
            hot[np.clip(pos, 0, spec.n_hot - 1)] == col)
    else:
        pos = np.zeros(col.shape, np.int64)
        in_hot = np.zeros(col.shape, bool)
    out = np.where(in_win, np.clip(local, 0, spec.win - 1),
                   np.where(in_hot, spec.win + pos, 0)).astype(np.int32)
    return out, in_win | in_hot | ~mask


def _local_cols(col_idx: np.ndarray, mask: np.ndarray, spec: ShardSpec,
                hot: np.ndarray) -> np.ndarray:
    """Remap the full (row-padded) ELL schedule to window-local slots."""
    n_rb_pad = spec.n_rb_pad
    padded = np.zeros((n_rb_pad, col_idx.shape[1]), np.int64)
    padded[:col_idx.shape[0]] = col_idx
    mask_full = np.zeros(padded.shape, bool)
    mask_full[:mask.shape[0]] = mask
    out, covered = _remap_cols(padded, mask_full,
                               _row_bases(spec, np.arange(n_rb_pad)),
                               spec, hot)
    if not covered.all():
        raise AssertionError("halo analysis must cover every real column")
    return out


def _hot_routing(spec: ShardSpec, hot: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device scatter routes for the hot-set replication.

    Device ``d`` owns the hot blocks lying in its row range; it writes its
    local block ``hot_local`` into slot ``hot_dst`` of the shared buffer
    (padded routes target the extra drop slot ``n_hot``).
    """
    owner = hot // spec.rb_per
    counts = np.bincount(owner, minlength=spec.n_dev)
    max_own = int(counts.max(initial=0))
    hot_local = np.zeros((spec.n_dev, max_own), np.int32)
    hot_dst = np.full((spec.n_dev, max_own), spec.n_hot, np.int32)
    for d in range(spec.n_dev):
        mine = np.nonzero(owner == d)[0]
        hot_local[d, :len(mine)] = hot[mine] - d * spec.rb_per
        hot_dst[d, :len(mine)] = mine
    return hot_local, hot_dst


class ShardedPlan:
    """Per-device row-block BSR shards of an InteractionPlan.

    Each per-shard list holds one tensor per position on the mesh axis, on
    that position's device: ``vals`` (rb_per, nbr, bs, bs), ``lcol``
    (rb_per, nbr) int32 window-local columns, ``mask`` (rb_per, nbr) bool,
    ``hot_local``/``hot_dst`` (max_own,) int64 hot-set routes.
    ``apply``/``matvec`` take charges on the wrapped plan's device and
    return the result there; the wrapped ``plan`` keeps serving
    permutation helpers, stats and the lifecycle.
    """

    def __init__(self, plan, mesh: Mesh, spec: ShardSpec,
                 vals: List[torch.Tensor], lcol: List[torch.Tensor],
                 mask: List[torch.Tensor], hot: np.ndarray,
                 hot_local: List[torch.Tensor],
                 hot_dst: List[torch.Tensor]):
        self.plan = plan
        self.mesh = mesh
        self.spec = spec
        self.devices = _same_type_devices(mesh, spec.axis, plan.device)
        self.vals = vals
        self.lcol = lcol
        self.mask = mask
        self.hot = hot            # (n_hot,) sorted global blocks, host
        self.hot_local = hot_local
        self.hot_dst = hot_dst
        self.shard_patches = 0    # incremental updates applied in place
        self.reshards = 0         # full re-shards (tier escalation)

    # -- compute -----------------------------------------------------------

    def _windows(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each device's charge window, gathered from the charge shards
        ``xs`` (one (rb_per*bs,) tensor per device) as the reference's
        ``ppermute``/``all_gather``/``psum`` would: the neighbours are
        cyclic, so device 0's left halo holds device n-1's tail (and no
        ``lcol`` points at it)."""
        spec, bs = self.spec, self.plan.bsr.bs
        n_dev, rb_per = spec.n_dev, spec.rb_per
        devs = self.devices
        hot = None
        if spec.n_hot:
            # each owner scatters its hot blocks into a buffer (slot n_hot
            # drops the padded routes); the buffers' sum is the hot set
            total = None
            for d in range(n_dev):
                buf = torch.zeros((spec.n_hot + 1, bs), dtype=xs[d].dtype,
                                  device=devs[d])
                buf[self.hot_dst[d]] = xs[d].reshape(rb_per, bs)[
                    self.hot_local[d]]
                buf = buf.to(devs[0], non_blocking=True)
                total = buf if total is None else total + buf
            hot = total[:spec.n_hot].reshape(-1)
        wins = []
        for d in range(n_dev):
            dev = devs[d]

            def take(j, lo=None, hi=None):
                return xs[j % n_dev][lo:hi].to(dev, non_blocking=True)

            if spec.mode == "allgather":
                parts = [take(j) for j in range(n_dev)]
            elif spec.mode == "ring":
                parts = ([take(d - h) for h in range(spec.hops_lo, 0, -1)]
                         + [xs[d]]
                         + [take(d + h) for h in range(1, spec.hops_hi + 1)])
            else:
                parts = [xs[d]]
                if spec.halo_lo:
                    parts.insert(0, take(d - 1, (rb_per - spec.halo_lo) * bs))
                if spec.halo_hi:
                    parts.append(take(d + 1, None, spec.halo_hi * bs))
            if hot is not None:
                parts.append(hot.to(dev, non_blocking=True))
            wins.append(torch.cat(parts) if len(parts) > 1 else parts[0])
        return wins

    def apply(self, x) -> torch.Tensor:
        """``y = A' x`` in cluster order via the sharded halo path: one B2
        launch per shard on a card."""
        home = self.plan.device
        x = from_numpy(x, home, torch.float32)
        if x.ndim != 1:
            raise ValueError(f"sharded plans take 1-D charges, got "
                             f"shape {tuple(x.shape)}")
        spec, bs = self.spec, self.plan.bsr.bs
        step = spec.rb_per * bs
        if x.shape[0] > spec.n_rb_pad * bs:
            raise ValueError(f"{x.shape[0]} charges for a plan of "
                             f"{self.plan.n} rows")
        xp = F.pad(x, (0, spec.n_rb_pad * bs - x.shape[0]))
        xs = [xp[d * step:(d + 1) * step].to(dev, non_blocking=True)
              for d, dev in enumerate(self.devices)]
        ys = []
        for d, win in enumerate(self._windows(xs)):
            # rectangular local operator: rb_per row blocks against the
            # window's win + n_hot column blocks; lcol was made in range
            # on the host
            y = _bsr.bsr_spmv(self.vals[d], self.lcol[d], win[:, None],
                              self.mask[d], indices_checked=True)
            ys.append(y[:, 0].to(home, non_blocking=True))
        return torch.cat(ys)[:self.plan.n]

    def matvec(self, x) -> torch.Tensor:
        """``y = A x`` in original order (permute ∘ apply ∘ unpermute)."""
        x = from_numpy(x, self.plan.device, torch.float32)
        return self.plan.unpermute(self.apply(self.plan.permute(x)))

    def solve(self, b, *, shift: float = 0.0,
              precond: Optional[str] = None, tol: Optional[float] = None,
              maxiter: Optional[int] = None):
        """CG on the sharded matvec (1-D right-hand sides only, the sharded
        apply's contract); the preconditioner factors from the wrapped
        plan's unsharded tiles. See ``repro_torch.solvers.krr.solve``."""
        from repro_torch.solvers.krr import solve as _solve
        return _solve(self, b, shift=shift, precond=precond, tol=tol,
                      maxiter=maxiter)

    # -- introspection -----------------------------------------------------

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def device(self) -> torch.device:
        """Where ``apply``/``matvec`` take and return charges: the wrapped
        plan's device."""
        return self.plan.device

    @property
    def transfer_fraction(self) -> float:
        """Charge blocks received per device, as a fraction of what a full
        all-gather of the (padded) charge vector would move."""
        ag = self.spec.allgather_blocks
        return self.spec.transfer_blocks / ag if ag else 0.0

    def unshard(self) -> BSR:
        """Reconstruct the unsharded BSR from the shard tensors (bit-exact
        inverse of :func:`shard`: unpad rows, window-local / hot-slot ->
        global columns, padded slots restored to column 0)."""
        b = self.plan.bsr
        spec = self.spec
        home = self.plan.device
        vals = torch.cat([v.to(home) for v in self.vals])[:b.n_rb]
        lcol = np.concatenate([to_numpy(c) for c in self.lcol]
                              )[:b.n_rb].astype(np.int64)
        mask = np.concatenate([to_numpy(m) for m in self.mask])[:b.n_rb]
        col = lcol + _row_bases(spec, np.arange(b.n_rb))[:, None]
        if spec.n_hot:
            far = lcol >= spec.win
            col[far] = self.hot[np.clip(lcol[far] - spec.win, 0,
                                        spec.n_hot - 1)]
        col = np.where(mask, col, 0)
        return BSR(bs=b.bs, sb=b.sb, n=b.n, n_rb=b.n_rb, n_cb=b.n_cb,
                   col_idx=from_numpy(col.astype(np.int32), home),
                   nbr_mask=from_numpy(mask, home), vals=vals,
                   fill=b.fill, max_nbr=b.max_nbr)

    # -- lifecycle (compose with api.refresh_plan / api.update_plan) -------

    def _register(self) -> "ShardedPlan":
        """Enter this ShardedPlan into its plan's shard memo (the same
        cache ``shard()`` and the ``dist`` backend consult)."""
        self.plan.host.shard_cache[(self.spec.n_dev, self.spec.axis)] = self
        return self

    def _handoff(self, prev: "ShardedPlan", patched: int = 0,
                 resharded: int = 0) -> "ShardedPlan":
        """Carry lineage telemetry from ``prev`` onto this plan."""
        self.shard_patches = prev.shard_patches + patched
        self.reshards = prev.reshards + resharded
        return self._register()

    def _absorb(self, new_plan, in_place_actions: Tuple[str, ...]
                ) -> "ShardedPlan":
        """Fold an already-updated wrapped plan into the shard tensors.

        When the update was one of ``in_place_actions`` (layout-preserving
        tiers that record ``last_patch_rb``), only the shards owning the
        touched row-blocks change, and each of those is a patched clone:
        this ShardedPlan stays valid (ROADMAP C6) and untouched shards keep
        their tensors — *provided* the new columns still fit the existing
        halo window. Everything else (rebucket/rebuild/compact/capacity
        growth, or a window overflow) re-shards the new plan.
        """
        st = new_plan.refresh_stats
        touched = new_plan.host.last_patch_rb
        same_layout = (
            st.last_action in in_place_actions and touched is not None
            and new_plan.bsr is not None and self.plan.bsr is not None
            and new_plan.bsr.n_rb == self.plan.bsr.n_rb
            and new_plan.bsr.max_nbr == self.plan.bsr.max_nbr)
        if not same_layout:
            return shard(new_plan, self.mesh, axis=self.spec.axis
                         )._handoff(self, resharded=1)
        if len(touched) == 0:      # nothing changed: shards already valid
            return ShardedPlan(new_plan, self.mesh, self.spec, self.vals,
                               self.lcol, self.mask, self.hot,
                               self.hot_local, self.hot_dst
                               )._handoff(self)

        spec = self.spec
        b = new_plan.bsr
        touched = np.asarray(touched, np.int64)
        col_np = to_numpy(b.col_idx[torch.from_numpy(touched).to(
            b.col_idx.device)]).astype(np.int64)
        mask_np = to_numpy(b.nbr_mask[torch.from_numpy(touched).to(
            b.nbr_mask.device)])
        local, covered = _remap_cols(col_np, mask_np,
                                     _row_bases(spec, touched), spec,
                                     self.hot)
        if not covered.all():
            # a changed row grew support beyond window + hot set
            return shard(new_plan, self.mesh, axis=self.spec.axis
                         )._handoff(self, resharded=1)
        vals, lcol, mask = list(self.vals), list(self.lcol), list(self.mask)
        owner = touched // spec.rb_per
        for d in np.unique(owner):
            sel = owner == d
            dev = self.devices[d]
            rows = torch.from_numpy(touched[sel] - d * spec.rb_per).to(dev)
            src = torch.from_numpy(touched[sel]).to(b.vals.device)
            vals[d] = vals[d].clone()
            vals[d][rows] = b.vals[src].to(dev)
            lcol[d] = lcol[d].clone()
            lcol[d][rows] = from_numpy(local[sel], dev)
            mask[d] = mask[d].clone()
            mask[d][rows] = from_numpy(mask_np[sel], dev)
        return ShardedPlan(new_plan, self.mesh, spec, vals, lcol, mask,
                           self.hot, self.hot_local, self.hot_dst
                           )._handoff(self, patched=1)

    def refresh(self, x_new, *, policy: Optional[str] = None
                ) -> "ShardedPlan":
        """Refresh the wrapped plan, then update shards incrementally: a
        patch-tier refresh patches only the shards owning migrated
        row-blocks (provided their new columns fit the halo window);
        rebucket/rebuild re-shard."""
        return self._absorb(self.plan.refresh(x_new, policy=policy),
                            ("patch",))

    def update(self, *, insert=None, delete=None,
               policy: Optional[str] = None) -> "ShardedPlan":
        """One streaming step on the wrapped plan, shards kept in sync:
        append/tombstone tiers patch the owning shards, a compaction (or
        capacity growth, or a halo-window overflow) re-shards the updated
        plan on the same mesh."""
        from repro_torch import api

        return self._absorb(
            api.update_plan(self.plan, insert=insert, delete=delete,
                            policy=policy),
            ("append", "tombstone"))

    def absorb(self, new_plan) -> "ShardedPlan":
        """Absorb an externally-updated successor of the wrapped plan — the
        shard-local half of a double-buffer swap
        (``core.doublebuf.DoubleBufferedPlan``): in-place steps patch the
        touched shards, a swapped-in rebucket/compact re-shards on the
        same mesh."""
        return self._absorb(new_plan, ("append", "tombstone", "patch"))

    def insert(self, x_new, *, policy: Optional[str] = None):
        """Streamed insert; returns ``(sharded_plan, physical_indices)``."""
        sp = self.update(insert=x_new, policy=policy)
        return sp, sp.plan.host.last_inserted_idx

    def delete(self, idx, *, policy: Optional[str] = None) -> "ShardedPlan":
        """Streamed delete (tombstone) of physical rows ``idx``."""
        return self.update(delete=idx, policy=policy)

    def __repr__(self) -> str:
        s = self.spec
        return (f"ShardedPlan(n={self.plan.n}, devices={s.n_dev}, "
                f"rb_per={s.rb_per}, mode={s.mode!r}, "
                f"halo=({s.halo_lo},{s.halo_hi}), hot={s.n_hot}, "
                f"transfer={self.transfer_fraction:.2f}x-allgather)")


def _same_type_devices(mesh: Mesh, axis: str, home: torch.device) -> list:
    """The devices of ``axis``, all of ``home``'s type, or a ValueError.
    ``apply`` copies asynchronously between the shards and the plan's
    device; a copy from a card into host memory would return before it
    landed."""
    devices = mesh.devices_along(axis)
    other = sorted({str(d) for d in devices if d.type != home.type})
    if other:
        raise ValueError(
            f"mesh axis {axis!r} holds {other}, but the plan lives on "
            f"{home}: build the plan on the mesh's device type or pass a "
            f"mesh of {home.type} devices")
    return devices


def _row_shards(t: torch.Tensor, spec: ShardSpec, devices) -> list:
    """Split ``t`` (n_rb, ...) into ``n_dev`` contiguous row ranges of
    ``rb_per``, zero-padding the last ones, each moved to its device (a
    view where the device is the tensor's own and no padding is needed)."""
    out = []
    for d, dev in enumerate(devices):
        part = t[d * spec.rb_per:(d + 1) * spec.rb_per]
        pad = spec.rb_per - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_zeros((pad,)
                                                   + tuple(t.shape[1:]))])
        out.append(part.to(dev))
    return out


def shard(plan, mesh: Optional[Mesh] = None, axis: str = "data"
          ) -> ShardedPlan:
    """Shard ``plan``'s row-blocks over ``mesh`` (default:
    ``default_mesh(axis)`` on the plan's device type).

    Analyzes the ELL schedule for the minimal halo exchange (plus hot
    set), remaps the column schedule to window-local coordinates, and
    places each device's tiles, columns and mask on it. Memoized per
    ``(device count, axis)`` on the plan host — repeated calls (including
    the ``dist`` backend's) return the same ShardedPlan while the plan's
    BSR and the mesh are the same.
    """
    if plan.bsr is None:
        raise ValueError("profile-only plan has no BSR to shard "
                         "(rebuild with with_bsr=True)")
    if mesh is None:
        mesh = default_mesh(axis, plan.device)
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes: "
                         f"{tuple(mesh.axis_names)}); pass axis=")
    devices = _same_type_devices(mesh, axis, plan.device)
    cache = plan.host.shard_cache
    key = (mesh.shape[axis], axis)
    sp = cache.get(key)
    if sp is not None and sp.plan.bsr is plan.bsr and sp.mesh == mesh:
        return sp
    b = plan.bsr
    spec, hot = analyze_shards(b, mesh.shape[axis], axis)
    mask_np = to_numpy(b.nbr_mask)
    lcol = _local_cols(to_numpy(b.col_idx), mask_np, spec, hot)
    hot_local, hot_dst = _hot_routing(spec, hot)
    mask_pad = np.zeros((spec.n_rb_pad, b.max_nbr), bool)
    mask_pad[:b.n_rb] = mask_np
    per = spec.rb_per
    return ShardedPlan(
        plan, mesh, spec, _row_shards(b.vals, spec, devices),
        [from_numpy(lcol[d * per:(d + 1) * per], dev)
         for d, dev in enumerate(devices)],
        [from_numpy(mask_pad[d * per:(d + 1) * per], dev)
         for d, dev in enumerate(devices)],
        hot,
        [from_numpy(hot_local[d].astype(np.int64), dev)
         for d, dev in enumerate(devices)],
        [from_numpy(hot_dst[d].astype(np.int64), dev)
         for d, dev in enumerate(devices)])._register()
