"""Host-side insert streaming for the decode service.

Every generated token must enter its session's per-head key plans (the
insert tier of ``api.update_plan``) WITHOUT re-running the Morton sort —
and without paying one ``api.update_plan`` round trip per (layer, head)
per tick. The inserter keeps device mirrors of the per-member embedding
frames and point sets, so a whole tick of insertions costs:

  one batched device pass     embed + live-candidate kNN for every
                              (layer, slot, head) member at once
  one stacked numpy pass      the Morton-leaf slot claims for ALL
                              L*B*H members (``claim_slots_batched`` —
                              the exact ``update_plan`` placement
                              arithmetic, vectorized over members)
  one device scatter          fold the landed rows into the mirrors

Host plan state (``alive``/``codes``/coordinates/refresh telemetry) is
mutated in place on the member ``_PlanHost`` objects. That is sound
because the append tier never reorders: the PlanBatch's stacked device
``data.pi/inv`` stay valid, and only ``data.alive`` goes stale (decode
liveness is carried by the engine's ``ps`` state instead, and every
trim/rebucket rebuilds the stack).

kNN edges are BUFFERED per engine slot and folded into the host COO by
:meth:`LockstepInserter.flush` — which the engine calls before anything
that reads the COO (trim, rebucket, snapshot).

Documented deviations from ``update_plan``'s insert tier (the claim
arithmetic itself is replicated exactly):
  - each arrival's kNN is taken against the pre-insert live set (one
    point per member per tick, so the batch-mate interactions
    ``update_plan`` resolves never arise, but the arrival also never
    picks a same-tick sibling);
  - reverse adoption (``api._adopt_arrivals``) is skipped — decode never
    reads the COO, and the next compaction re-exactifies the pattern;
  - edge folding is deferred to :meth:`flush`.

Counterpart of the reference's ``repro.serve.streaming``: the host logic
is its numpy, the device mirrors are float32 tensors on the inserter's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, to_numpy
from repro_torch.core import hierarchy
from repro_torch.core.clusterkv import topk_stable


# -- batched Morton codes with per-member boxes ------------------------------
#
# ``hierarchy.morton_codes_box`` quantizes against ONE box; members each
# have their own frozen box. The quantization is elementwise, so a numpy
# replica with broadcast boxes is bitwise-identical per row.


def _np_part1by1(v: np.ndarray) -> np.ndarray:
    v = v & np.uint32(0xFFFF)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def _np_part1by2(v: np.ndarray) -> np.ndarray:
    v = v & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def morton_codes_boxes(y: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                       bits: int) -> np.ndarray:
    """Row-wise :func:`hierarchy.morton_codes_box`: ``y``/``lo``/``hi`` all
    (..., d), each row quantized against its own box. Returns uint64."""
    y = np.asarray(y, np.float32)
    d = y.shape[-1]
    b = hierarchy.eff_bits(d, bits)
    span = np.maximum(hi - lo, np.float32(1e-30)).astype(np.float32)
    q = np.clip((y - lo) / span * (2 ** b - 1), 0, 2 ** b - 1
                ).astype(np.uint32)
    if d == 1:
        code = q[..., 0]
    elif d == 2:
        code = _np_part1by1(q[..., 0]) | (_np_part1by1(q[..., 1]) << 1)
    elif d == 3:
        code = (_np_part1by2(q[..., 0])
                | (_np_part1by2(q[..., 1]) << 1)
                | (_np_part1by2(q[..., 2]) << 2))
    else:
        raise ValueError(f"morton codes support d<=3, got d={d}")
    return code.astype(np.uint64)


def claim_slot(host, code: np.uint64) -> int:
    """Claim the free plan slot nearest a single arrival's Morton leaf —
    ``update_plan``'s ``insertion_positions`` + ``claim_free_slots``
    arithmetic specialized to one insert (no list churn). Returns the
    claimed PHYSICAL row.

    Reference semantics for :func:`claim_slots_batched` (which the
    per-tick insert path uses — one call for all L*B*H members instead
    of one Python claim per member); kept for tests."""
    in_order = host.codes[host.pi]
    free_pos = np.nonzero(~host.alive[host.pi])[0]
    if free_pos.size == 0:
        raise ValueError("no free plan slots; session outgrew its capacity")
    env = np.maximum.accumulate(in_order)
    t = int(np.searchsorted(env, code))
    j = int(np.searchsorted(free_pos, t))      # == bisect_left(free, t)
    if j == len(free_pos):
        j -= 1
    elif j > 0 and t - free_pos[j - 1] <= free_pos[j] - t:
        j -= 1
    return int(host.pi[free_pos[j]])


CLAIM_BLOCK = 128        # block-maxima granularity of the two-level search


def claim_slots_batched(codes_io: np.ndarray, alive_io: np.ndarray,
                        codes: np.ndarray,
                        block_max: np.ndarray | None = None) -> np.ndarray:
    """Vectorized :func:`claim_slot` over M stacked members.

    ``codes_io``/``alive_io`` (M, C) are each member's codes/liveness IN
    PLAN ORDER (``host.codes[host.pi]`` / ``host.alive[host.pi]``);
    ``codes`` (M,) the arrival Morton codes. Returns the claimed IN-ORDER
    positions (M,) int64 — callers map to physical rows via ``host.pi``.
    ``block_max`` (M, C/CLAIM_BLOCK), if given, is the per-block maximum
    of ``codes_io`` — a mirror the streaming inserter maintains
    incrementally so the search never rescans the full code arrays.

    Exactly the scalar arithmetic, restructured so the per-tick cost is
    far below M scalar claims:

    * the sorted-envelope ``searchsorted`` needs no cumulative max at
      all — ``env[j] < code`` iff every code through ``j`` is below it,
      so the target ``t`` is just the FIRST in-order position whose code
      is ``>= code`` (one stacked comparison + argmax);
    * the nearest-free bisect only ever resolves within ``t``'s
      neighborhood, so the free mask is gathered in a +-W window around
      ``t``. A window miss on a side can never flip the scalar
      tie-break (the in-window candidate is closer by construction than
      anything beyond the window), and members with no free slot within
      the window at all fall back to the scalar bisect.

    Each member is an independent host, so one tick's claims never
    interact and the batch is exact."""
    m, c = codes_io.shape
    free = ~alive_io
    if not free.any(axis=1).all():
        raise ValueError("no free plan slots; session outgrew its capacity")
    rows = np.arange(m)
    bs = CLAIM_BLOCK
    if c % bs == 0 and c >= 2 * bs:
        # two-level: per-block maxima narrow the first >= code to one
        # block per member, so only that block's codes are compared
        bm = (block_max if block_max is not None
              else codes_io.reshape(m, c // bs, bs).max(axis=2))
        gb = bm >= codes[:, None]
        blk = gb.argmax(axis=1)
        ge = codes_io[rows[:, None],
                      blk[:, None] * bs + np.arange(bs)] >= codes[:, None]
        t = blk * bs + ge.argmax(axis=1)
        t = np.where(gb[rows, blk], t, c).astype(np.int64)
    else:
        ge = codes_io >= codes[:, None]
        t = ge.argmax(axis=1).astype(np.int64)
        t = np.where(ge[rows, t], t, c)            # all-below rows -> c
    w = min(128, c)
    cols = t[:, None] + np.arange(-w, w)           # positions t-w .. t+w-1
    fw = (free[rows[:, None], np.clip(cols, 0, c - 1)]
          & (cols >= 0) & (cols < c))
    fl, fr = fw[:, :w], fw[:, w:]
    has_l, has_r = fl.any(axis=1), fr.any(axis=1)
    pf = np.where(has_l, t - 1 - np.argmax(fl[:, ::-1], axis=1), -1)
    nf = np.where(has_r, t + np.argmax(fr, axis=1), c)
    use_pf = (nf >= c) | ((pf >= 0) & (t - pf <= nf - t))
    chosen = np.where(use_pf, pf, nf)
    for i in np.nonzero(~(has_l | has_r))[0]:      # no free within +-w
        fp = np.nonzero(free[i])[0]
        j = int(np.searchsorted(fp, t[i]))
        if j == len(fp):
            j -= 1
        elif j > 0 and t[i] - fp[j - 1] <= fp[j] - t[i]:
            j -= 1
        chosen[i] = fp[j]
    return chosen.astype(np.int64)


def _embed_knn(k_new: torch.Tensor, mean: torch.Tensor, axes: torch.Tensor,
               x: torch.Tensor, alive: torch.Tensor, knn: int):
    """Batched §2.4 step-1 embed + exact kNN against the live mirror.

    k_new (L,B,H,dh); mean (L,B,H,dh); axes (L,B,H,dh,d);
    x (L,B,H,C,dh); alive (L,B,H,C). Returns (y, idx, d2). Dead slots
    score ``+inf``; the ``knn`` nearest come in ascending distance with
    ties to the lowest slot (``lax.top_k`` over ``-d2``, whose order
    ``topk_stable`` keeps)."""
    k32 = k_new.float()
    y = torch.einsum("lbhd,lbhde->lbhe", k32 - mean, axes)
    d2 = ((x - k32[..., None, :]) ** 2).sum(-1)
    d2 = d2.masked_fill(~alive, float("inf"))
    idx = topk_stable(-d2, knn)
    return y, idx, torch.gather(d2, -1, idx)


class LockstepInserter:
    """Streams one generated key per (layer, head) member per tick into
    every attached session's plans, in lockstep across engine slots.

    The device mirrors (``_mean``, ``_axes``, ``_x``, ``_alive``) are
    float32 tensors on ``device`` (``None`` = ``"cuda"``); the stacked
    claim state stays in numpy."""

    def __init__(self, n_layers: int, slots: int, n_heads: int,
                 capacity: int, head_dim: int, embed_d: int, knn: int,
                 device: DeviceLike = None):
        self.L, self.B, self.H = n_layers, slots, n_heads
        self.C, self.dh, self.d = capacity, head_dim, embed_d
        self.knn = knn
        self.device = dev = resolve_device(device)
        lbh = (self.L, self.B, self.H)
        self._mean = torch.zeros(lbh + (head_dim,), device=dev)
        self._axes = torch.zeros(lbh + (head_dim, embed_d), device=dev)
        self._x = torch.zeros(lbh + (capacity, head_dim), device=dev)
        self._alive = torch.zeros(lbh + (capacity,), dtype=torch.bool,
                                  device=dev)
        # per-member frozen quantization boxes (host-side, tiny)
        self._lo = np.zeros(lbh + (embed_d,), np.float32)
        self._hi = np.ones(lbh + (embed_d,), np.float32)
        # host-side stacked claim state, IN PLAN ORDER per member — the
        # inputs of claim_slots_batched. Staged at attach, updated in
        # place on every claim so they stay exact mirrors of
        # host.codes[host.pi] / host.alive[host.pi] / host.pi.
        self._pi_io = np.zeros(lbh + (capacity,), np.int64)
        self._codes_io = np.zeros(lbh + (capacity,), np.uint64)
        self._alive_io = np.zeros(lbh + (capacity,), bool)
        # incrementally-maintained per-block code maxima (the two-level
        # claim search's upper tier); None when capacity doesn't tile
        self._bmax_io = (
            np.zeros(lbh + (capacity // CLAIM_BLOCK,), np.uint64)
            if capacity % CLAIM_BLOCK == 0 and capacity >= 2 * CLAIM_BLOCK
            else None)
        self._plans: List[Optional[list]] = [None] * slots
        # slot -> list of per-tick records ((L,H) phys, (L,H,knn) nbr_idx,
        # (L,H,knn) nbr_d2); one append per slot per tick, folded by flush
        # in a single concatenation pass
        self._buf: Dict[int, list] = {}
        self._bits: Optional[int] = None
        # plan generation each slot was attached at: claims mutate the
        # member hosts in place, which is only sound against the exact
        # plan objects staged at attach time — trim/rebucket/restore
        # replace them and must re-attach with the incoming generation
        self._gen: List[int] = [0] * slots

    # -- session lifecycle --------------------------------------------------

    def attach(self, slot: int, plans: list, generation: int = 0) -> None:
        """Bind a session's per-layer plan batches to an engine slot and
        stage their frames/points into the device mirrors.

        Re-attach after any operation that replaced the member hosts
        (trim, rebucket, restore), passing the plans' current
        ``generation`` — later claims are validated against it, so an
        insert streamed at a stale generation raises instead of silently
        mutating hosts the serving plan no longer reads."""
        from repro_torch import api

        cfg = plans[0].spec.config
        self._bits = cfg.bits
        mean = np.zeros((self.L, self.H, self.dh), np.float32)
        axes = np.zeros((self.L, self.H, self.dh, self.d), np.float32)
        xs = np.zeros((self.L, self.H, self.C, self.dh), np.float32)
        alv = np.zeros((self.L, self.H, self.C), bool)
        for l, pb in enumerate(plans):
            for h, host in enumerate(pb.hosts):
                if host.codes is None:
                    # first streamed insert of this lineage: freeze the
                    # quantization box + seed hole codes, exactly as
                    # update_plan would lazily
                    codes, lo, hi = api._stream_codes(host, cfg, self.device)
                    host.codes, host.code_lo, host.code_hi = codes, lo, hi
                mean[l, h] = host.embed_mean
                axes[l, h] = host.embed_axes
                xs[l, h] = host.x
                alv[l, h] = host.alive
                self._lo[l, slot, h] = host.code_lo
                self._hi[l, slot, h] = host.code_hi
                self._pi_io[l, slot, h] = host.pi
                self._codes_io[l, slot, h] = host.codes[host.pi]
                self._alive_io[l, slot, h] = host.alive[host.pi]
                if self._bmax_io is not None:
                    self._bmax_io[l, slot, h] = self._codes_io[
                        l, slot, h].reshape(-1, CLAIM_BLOCK).max(axis=1)
        dev = self.device
        self._mean[:, slot] = torch.from_numpy(mean).to(dev)
        self._axes[:, slot] = torch.from_numpy(axes).to(dev)
        self._x[:, slot] = torch.from_numpy(xs).to(dev)
        self._alive[:, slot] = torch.from_numpy(alv).to(dev)
        self._plans[slot] = plans
        self._gen[slot] = generation

    def generation(self, slot: int) -> int:
        """The plan generation ``slot`` was last attached at."""
        return self._gen[slot]

    def detach(self, slot: int) -> None:
        self._plans[slot] = None
        self._alive[:, slot] = False
        self._alive_io[:, slot] = False
        self._buf.pop(slot, None)

    # -- the per-tick insert ------------------------------------------------

    def insert(self, active: List[int], k_new: torch.Tensor,
               generations: Optional[Dict[int, int]] = None) -> np.ndarray:
        """Stream one key per (layer, head) member of every active slot.

        ``k_new`` (L, B, H, dh) tensor (inactive lanes ignored). Claims a
        plan slot per member via the exact update_plan placement, mutates
        the member hosts in place, buffers the arrivals' kNN edges, and
        refreshes the device mirrors. Returns the claimed PHYSICAL rows
        (L, B, H) int64, -1 on inactive lanes.

        ``generations`` (slot -> caller's current plan generation)
        validates each claim against the generation the slot was attached
        at: after a swap replaced a session's plans, a claim against the
        stale attachment raises ``RuntimeError`` instead of mutating hosts
        the serving plan no longer reads — re-attach with the incoming
        generation first."""
        if generations is not None:
            for s in active:
                got = generations.get(s, self._gen[s])
                if got != self._gen[s]:
                    raise RuntimeError(
                        f"slot {s} plans are at generation {got} but the "
                        f"inserter was attached at {self._gen[s]}; "
                        "re-attach after a plan swap before streaming")
        for s in active:
            if self._plans[s] is None:
                raise ValueError(f"slot {s} has no attached session")
        k_new = torch.as_tensor(k_new, device=self.device)
        y, nidx, nd2 = _embed_knn(k_new, self._mean, self._axes, self._x,
                                  self._alive, self.knn)
        y_np = to_numpy(y)
        k_np = to_numpy(k_new.float())
        nidx_np, nd2_np = to_numpy(nidx), to_numpy(nd2)
        codes = morton_codes_boxes(y_np, self._lo, self._hi, self._bits)

        phys = np.full((self.L, self.B, self.H), -1, np.int64)
        if active:
            # one stacked claim pass for every (layer, slot, head) member
            sl = np.asarray(active, np.int64)
            m = self.L * len(active) * self.H
            chosen = claim_slots_batched(
                self._codes_io[:, sl].reshape(m, self.C),
                self._alive_io[:, sl].reshape(m, self.C),
                codes[:, sl].reshape(m),
                block_max=(None if self._bmax_io is None else
                           self._bmax_io[:, sl].reshape(m, -1)))
            li, si, hi = [ix.reshape(m) for ix in np.meshgrid(
                np.arange(self.L), sl, np.arange(self.H), indexing="ij")]
            p_all = self._pi_io[li, si, hi, chosen]
            phys[li, si, hi] = p_all
            # keep the in-order mirrors exact: the claimed position turns
            # alive and takes the arrival's code (host.codes[p] below is
            # the same mutation seen through host.pi)
            self._alive_io[li, si, hi, chosen] = True
            self._codes_io[li, si, hi, chosen] = codes[li, si, hi]
            if self._bmax_io is not None:
                # overwriting a hole's seed code can RAISE OR LOWER its
                # block max; recompute just the touched blocks
                blk = chosen // CLAIM_BLOCK
                seg = self._codes_io[
                    li[:, None], si[:, None], hi[:, None],
                    (blk * CLAIM_BLOCK)[:, None] + np.arange(CLAIM_BLOCK)]
                self._bmax_io[li, si, hi, blk] = seg.max(axis=1)

        for s in active:
            plans = self._plans[s]
            for l, pb in enumerate(plans):
                for h, host in enumerate(pb.hosts):
                    p = int(phys[l, s, h])
                    prev = int(host.alive.sum())
                    host.alive[p] = True
                    host.x[p] = k_np[l, s, h]
                    host.embedding[p] = y_np[l, s, h]
                    if host.y_last is not None:
                        host.y_last[p] = y_np[l, s, h]
                    host.codes[p] = codes[l, s, h]
                    host.peak_alive = max(host.peak_alive or 0, prev + 1)
                    host.last_inserted_idx = np.asarray([p], np.int64)
                    host.gamma = None
                    host.compact_map = None
                    host.refresh = dataclasses.replace(
                        host.refresh,
                        appends=host.refresh.appends + 1,
                        inserted_total=host.refresh.inserted_total + 1,
                        last_action="append")
            self._buf.setdefault(s, []).append(
                (phys[:, s].copy(), nidx_np[:, s], nd2_np[:, s]))

        # land the claimed rows in the mirrors: active lanes only (the
        # reference drops a sentinel row; PyTorch has no drop mode)
        lane = np.nonzero(phys >= 0)
        if lane[0].size:
            ix = [torch.from_numpy(a).to(self.device)
                  for a in (*lane, phys[lane])]
            self._x[ix[0], ix[1], ix[2], ix[3]] = \
                k_new[ix[0], ix[1], ix[2]].float()
            self._alive[ix[0], ix[1], ix[2], ix[3]] = True
        return phys

    # -- COO folding --------------------------------------------------------

    def flush(self, slot: int) -> int:
        """Fold the slot's buffered kNN edges into each member's host COO
        (cluster space, current ordering). Call before anything that reads
        or rewrites the COO: trim, rebucket, snapshot. Returns the number
        of edges folded.

        The buffer holds one record per tick; stacking them gives each
        member its whole backlog as one (T*knn,) slab, so the fold is a
        single concatenation pass per member instead of per-tick list
        churn."""
        from repro_torch import api

        plans = self._plans[slot]
        ticks = self._buf.pop(slot, [])
        if not ticks or plans is None:
            return 0
        phys = np.stack([t[0] for t in ticks])      # (T, L, H)
        nidx = np.stack([t[1] for t in ticks])      # (T, L, H, knn)
        nd2 = np.stack([t[2] for t in ticks])
        folded = 0
        for l, pb in enumerate(plans):
            for h, host in enumerate(pb.hosts):
                rows = np.repeat(phys[:, l, h], self.knn)
                cols = nidx[:, l, h].reshape(-1)
                d2 = nd2[:, l, h].reshape(-1)
                keep = host.alive[cols]      # neighbors trimmed since claim
                rows, cols, d2 = rows[keep], cols[keep], d2[keep]
                if rows.size == 0:
                    continue
                vals = api.edge_values(host, rows, cols, d2)
                r2, c2, v2 = host.coo
                host.coo = (np.concatenate([r2, host.inv[rows]]),
                            np.concatenate([c2, host.inv[cols]]),
                            np.concatenate([v2, vals]))
                host.coo_dev = None
                folded += int(rows.size)
        return folded

    def flush_all(self) -> int:
        return sum(self.flush(s) for s in range(self.B)
                   if self._plans[s] is not None)
