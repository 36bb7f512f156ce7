"""ClusterKV decode service: plan-cached continuous batching.

``ClusterKVEngine`` extends the port's
:class:`~repro_torch.train.serve_loop.Engine` with plans as first-class
serving state. The per-call clusterkv decode path re-derives the cluster
ordering of every slot's cache each tick (a Morton sort per token); the
service instead

  - builds one ordering ``PlanBatch`` per layer at ADMISSION
    (:func:`repro_torch.core.clusterkv.kv_plan_batch` over the prefilled
    keys, ``capacity=max_seq``) and keeps the slot's KV cache in PLAN
    order,
  - streams each generated key into those plans through the insert tier
    (:class:`~repro_torch.serve.streaming.LockstepInserter` — claim a
    Morton-leaf slot host-side, scatter device-side; never re-sort),
  - admits by SPEC UNIFICATION: every session is built to the same
    capacity and plan config, so ``PlanSpec`` equality guarantees a new
    session re-enters the one decode step signature.

The decode runs eagerly, so where the reference counts jit traces,
``decode_traces`` counts the distinct input signatures (shapes and dtypes
of ``pstate``, ``pend``, ``tokens`` and ``slot_pos``; of the cache,
``tokens`` and ``slot_pos`` in ``mode="percall"``) the decode step has
been called with — what spec unification guarantees, and the key a CUDA
graph capture of the tick would use. The service gate is that it stays 1
across arbitrary admission churn. ``prefill_traces`` counts the distinct
bucket lengths of the flash prefill plus those of the plan prefill.

On a CUDA device every tick attends through the ``cuda`` decode backend
(B5 in plan mode with the self column) and ``plan_prefill=True`` prefills
through B6.

``mode="percall"`` runs the same engine over the baseline per-call
clusterkv decode (``backend="clusterkv"``) for A/B comparison.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import DeviceLike, from_numpy, to_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import clusterkv as ckv
from repro_torch.serve.session import Session, SessionStore
from repro_torch.serve.streaming import LockstepInserter
from repro_torch.train.serve_loop import Engine, Request

_BIG = np.iinfo(np.int32).max


def _slot_centroids(ks: torch.Tensor, bk: int) -> torch.Tensor:
    """(L, Hkv, S, dh) plan-ordered keys of one slot -> (L, Hkv, S/bk, dh)
    float32 tile means."""
    l, h, s, dh = ks.shape
    return ks.float().reshape(l, h, s // bk, bk, dh).mean(3)


def _device_trim(pstate, rows: np.ndarray, slot: int, bk: int) -> None:
    """Zero the trimmed plan rows of one engine slot and recompute its
    centroids, in place. ``rows`` (L, Hkv, nd) plan-order rows (sentinel
    S: skip)."""
    ks, vs, ps = pstate["ks"], pstate["vs"], pstate["ps"]
    l, _, h, s, _ = ks.shape
    li, hi, ri = np.nonzero(rows < s)
    ix = [torch.from_numpy(a).to(ks.device)
          for a in (li, hi, rows[li, hi, ri])]
    ks[ix[0], slot, ix[1], ix[2]] = 0.0
    vs[ix[0], slot, ix[1], ix[2]] = 0.0
    ps[ix[0], slot, ix[1], ix[2]] = _BIG
    pstate["cent"][:, slot] = _slot_centroids(ks[:, slot], bk)


def _device_regather(pstate, gather: torch.Tensor, slot: int, bk: int
                     ) -> None:
    """Reorder one engine slot's plan-ordered rows after a host rebucket,
    in place: ``gather`` (L, Hkv, S) maps new plan row -> old plan row."""
    dh = pstate["ks"].shape[-1]
    g = gather.long()
    ks = torch.gather(pstate["ks"][:, slot], 2,
                      g[..., None].expand(-1, -1, -1, dh))
    vs = torch.gather(pstate["vs"][:, slot], 2,
                      g[..., None].expand(-1, -1, -1, dh))
    ps = torch.gather(pstate["ps"][:, slot], 2, g)
    pstate["ks"][:, slot] = ks
    pstate["vs"][:, slot] = vs
    pstate["ps"][:, slot] = ps
    pstate["cent"][:, slot] = _slot_centroids(ks, bk)


def _signature(*trees) -> tuple:
    """Shapes and dtypes of every tensor in ``trees`` (dicts or tensors),
    in key order: the input signature of one decode call."""
    sig = []
    for t in trees:
        items = sorted(t.items()) if isinstance(t, dict) else [("", t)]
        for key, a in items:
            a = torch.as_tensor(a)
            sig.append((key, tuple(a.shape), str(a.dtype)))
    return tuple(sig)


class ClusterKVEngine(Engine):
    """Continuous batching with plan-cached clusterkv decode.

    mode="plan"     plan-ordered caches + insert-streamed session plans
                    (ONE decode signature for the service's lifetime)
    mode="percall"  baseline: time-ordered cache, per-tick Morton sort
                    (``Engine`` with backend="clusterkv")

    ``device`` as for :class:`~repro_torch.train.serve_loop.Engine`
    (``None`` = ``"cuda"``).
    """

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_seq: int = 512, prefill_bucket: int = 64,
                 mode: str = "plan", knn: int = 8,
                 plan_prefill: bool = False, device: DeviceLike = None):
        if mode not in ("plan", "percall"):
            raise ValueError(f"unknown service mode {mode!r}")
        if not cfg.clusterkv.enabled:
            cfg = dataclasses.replace(
                cfg, clusterkv=dataclasses.replace(cfg.clusterkv,
                                                   enabled=True))
        if mode == "plan" and cfg.mla is not None:
            raise NotImplementedError("plan service serves GQA caches")
        self.mode = mode
        self.knn = knn
        self.plan_prefill = plan_prefill
        self._decode_sigs = set()
        self._pf_flash = set()
        self._pf_plan = set()
        self.tokens_out = 0
        self._tick_time = 0.0
        # plan-mode tick split: the decode step (ending on the argmax read)
        # vs the host inserter's claim-and-mutate pass
        self._device_time = 0.0
        self._claim_time = 0.0
        backend = "clusterkv" if mode == "percall" else "flash"
        super().__init__(cfg, params, slots=slots, max_seq=max_seq,
                         prefill_bucket=prefill_bucket, backend=backend,
                         device=device)
        self.store = SessionStore()
        bk = min(self.cfg.clusterkv.block_k, max_seq)
        if max_seq % bk:
            raise ValueError("max_seq must be a multiple of block_k")
        self.bk = bk
        self.L = self.cfg.n_layers
        self.Hkv = self.cfg.n_kv_heads
        self.dh = self.cfg.head_dim
        if mode == "plan":
            dt = self.mod.compute_dtype(self.cfg)
            dev = self.device
            shape = (self.L, slots, self.Hkv)
            self.pstate = {
                "ks": torch.zeros(shape + (max_seq, self.dh), dtype=dt,
                                  device=dev),
                "vs": torch.zeros(shape + (max_seq, self.dh), dtype=dt,
                                  device=dev),
                "ps": torch.full(shape + (max_seq,), _BIG,
                                 dtype=torch.int32, device=dev),
                "cent": torch.zeros(shape + (max_seq // bk, self.dh),
                                    device=dev),
            }
            self._pend_k = torch.zeros(shape + (self.dh,), dtype=dt,
                                       device=dev)
            self._pend_v = torch.zeros(shape + (self.dh,), dtype=dt,
                                       device=dev)
            self._pend_phys = np.full(shape, -1, np.int64)
            self._pend_pos = np.zeros(slots, np.int32)
            self._slot_sess: List[Optional[Session]] = [None] * slots
            self._tier_totals = {"appends": 0, "tombstones": 0,
                                 "rebuckets": 0, "grows": 0,
                                 "compactions": 0}
            # per-slot plan generation: bumped whenever a session's plan
            # objects are replaced (trim/rebucket/restore); every inserter
            # claim is validated against it
            self._plan_gen = [0] * slots
            self.inserter = LockstepInserter(
                self.L, slots, self.Hkv, max_seq, self.dh,
                self.cfg.clusterkv.embed_dim, knn, device=dev)

    @property
    def decode_traces(self) -> int:
        """Distinct input signatures the decode step has been called with
        (the eager port's count of what the reference's jit traces)."""
        return len(self._decode_sigs)

    # -- the decode steps ---------------------------------------------------

    def _decode_step(self, params, cache, tokens, slot_pos):
        self._decode_sigs.add(_signature(
            {k: v for k, v in cache.items() if k != "pos"}, tokens,
            slot_pos))
        return super()._decode_step(params, cache, tokens, slot_pos)

    def _plan_decode(self, params, pstate, pend, tokens, slot_pos):
        self._decode_sigs.add(_signature(pstate, pend, tokens, slot_pos))
        return self.mod.plan_decode_step(params, self.cfg, pstate, pend,
                                         tokens, slot_pos)

    # -- admission ----------------------------------------------------------

    def _install(self, s: int, req: Request, cache_1, blen: int):
        """Plan-mode admission: build the session's per-layer plan batches
        over the prefilled keys (capacity = max_seq, so every admission
        re-unifies to the SAME spec) and stage the slot's plan-ordered
        decode state. Returns plan-path logits when ``plan_prefill`` is
        set (the clusterkv_attention(plan_batch=) wiring), else None."""
        self._pf_flash.add(blen)
        if self.mode != "plan":
            return super()._install(s, req, cache_1, blen)
        if blen <= self.knn:
            raise ValueError(
                f"prefill bucket {blen} must exceed knn={self.knn} (spec "
                "unification pins every member's k to knn)")
        t0 = time.perf_counter()
        k1, v1 = cache_1["k"][:, 0], cache_1["v"][:, 0]   # (L,Hkv,blen,dh)
        S = self.max_seq
        plans = [ckv.kv_plan_batch(k1[l], d=self.cfg.clusterkv.embed_dim,
                                   knn=self.knn, capacity=S,
                                   device=self.device)
                 for l in range(self.L)]
        self._sync()
        t1 = time.perf_counter()
        # physical row p < blen holds the key of time position p; tail rows
        # are capacity holes (INT32_MAX position sentinel)
        pi = np.stack([np.stack([h.pi for h in pb.hosts])
                       for pb in plans])                   # (L,Hkv,S)
        dev = self.device
        pi_t = from_numpy(pi, dev, torch.int64)
        dt = self.pstate["ks"].dtype
        k_pad = torch.zeros((self.L, self.Hkv, S, self.dh), dtype=dt,
                            device=dev)
        v_pad = torch.zeros_like(k_pad)
        k_pad[:, :, :blen] = k1
        v_pad[:, :, :blen] = v1
        idx = pi_t[..., None].expand(-1, -1, -1, self.dh)
        ks = torch.gather(k_pad, 2, idx)
        self.pstate["ks"][:, s] = ks
        self.pstate["vs"][:, s] = torch.gather(v_pad, 2, idx)
        self.pstate["ps"][:, s] = torch.where(
            pi_t < blen, pi_t, _BIG).to(torch.int32)
        self.pstate["cent"][:, s] = _slot_centroids(ks, self.bk)
        self._pend_phys[:, s] = -1
        self._plan_gen[s] = 0
        self.inserter.attach(s, plans, generation=0)
        sess = Session(rid=req.rid, slot=s, blen=blen, plans=plans)
        self.store.admit(sess)
        self._slot_sess[s] = sess
        self._sync()
        t2 = time.perf_counter()
        self.timings.setdefault("plan_build_s", []).append(t1 - t0)
        self.timings.setdefault("stage_s", []).append(t2 - t1)
        if not self.plan_prefill:
            return None
        # re-run prefill THROUGH the plans: per-head live orderings drive
        # clusterkv_attention's plan_batch path, so the first generated
        # token already comes from the clusterkv kernels
        self._pf_plan.add(blen)
        perms = np.stack([
            np.stack([pi[l, h][pi[l, h] < blen] for h in range(self.Hkv)])
            for l in range(self.L)])                       # (L,Hkv,blen)
        plen = len(req.tokens)
        padded = np.zeros(blen, np.int64)
        padded[-plen:] = req.tokens
        logits = self.mod.plan_prefill(
            self.params, self.cfg,
            {"tokens": torch.from_numpy(padded[None]).to(dev)},
            torch.from_numpy(perms[:, None]).to(dev))
        self._sync()
        self.timings.setdefault("plan_prefill_s", []).append(
            time.perf_counter() - t2)
        return logits

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _release(self, s: int, req: Request) -> None:
        if self.mode != "plan":
            return
        sess = self._slot_sess[s]
        if sess is None:
            return
        self.store.counters["flushed_edges"] += self.inserter.flush(s)
        self.inserter.detach(s)
        self._pend_phys[:, s] = -1
        self._slot_sess[s] = None
        for pb in sess.plans:
            for host in pb.hosts:
                for key in self._tier_totals:
                    self._tier_totals[key] += getattr(host.refresh, key, 0)
        self.store.retire(sess.rid)

    # -- the tick -----------------------------------------------------------

    def step(self) -> int:
        t0 = time.perf_counter()
        n = self._plan_step() if self.mode == "plan" else super().step()
        self.tokens_out += n
        self._tick_time += time.perf_counter() - t0
        return n

    def _pend_slots(self) -> np.ndarray:
        """Plan-order landing rows of the pending tokens, resolved against
        the CURRENT member orderings (physical slots are stable across
        trims/rebuckets; plan rows are not). Sentinel max_seq = none."""
        out = np.full((self.L, self.slots, self.Hkv), self.max_seq, np.int32)
        for s in range(self.slots):
            sess = self._slot_sess[s]
            if sess is None:
                continue
            for l in range(self.L):
                for h in range(self.Hkv):
                    p = self._pend_phys[l, s, h]
                    if p >= 0:
                        out[l, s, h] = sess.plans[l].hosts[h].inv[p]
        return out

    def _plan_step(self) -> int:
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].output[-1]
        dev = self.device
        t_tick = time.perf_counter()
        pend = {"k": self._pend_k, "v": self._pend_v,
                "slot": torch.from_numpy(self._pend_slots()).to(dev),
                "pos": torch.from_numpy(self._pend_pos.copy()).to(dev)}
        t0 = time.perf_counter()
        logits, self.pstate, nk, nv = self._plan_decode(
            self.params, self.pstate, pend, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(self.slot_pos.copy()).to(dev))
        nxt = to_numpy(torch.argmax(logits, -1))
        t1 = time.perf_counter()
        self._device_time += t1 - t0
        # stream this tick's keys into the session plans: the host claims
        # each one's Morton-leaf slot now; the device lands it next tick
        phys = self.inserter.insert(
            active, nk,
            generations={s: self._plan_gen[s] for s in active})
        t2 = time.perf_counter()
        self._claim_time += t2 - t1
        self.timings["tick_s"].append(t2 - t_tick)
        self._pend_phys = phys
        self._pend_k, self._pend_v = nk, nv
        self._pend_pos = self.slot_pos.copy()
        for s in active:
            sess = self._slot_sess[s]
            sess.phys_hist[int(self.slot_pos[s])] = phys[:, s, :].copy()
            self.slot_pos[s] += 1
            self.slot_req[s].output.append(int(nxt[s]))
        self.store.counters["inserts"] += len(active)
        self.ticks += 1
        return len(active)

    # -- session surgery ----------------------------------------------------

    def trim(self, rid: int, positions: Sequence[int]) -> None:
        """Tombstone the given TIME positions out of a live session: the
        member plans take the tombstone tier (capacity keeps the spec, so
        the decode signature holds), the device rows are zeroed and
        re-holed. Repeated positions count once (the reference sizes the
        batch by the raw list and so also tombstones row 0 for each
        repeat)."""
        sess = self.store.get(rid)
        if sess is None:
            raise KeyError(f"no live session {rid}")
        s = sess.slot
        self.store.counters["flushed_edges"] += self.inserter.flush(s)
        positions = sorted(set(int(p) for p in positions))
        del_rows = np.zeros((self.L, self.Hkv, len(positions)), np.int64)
        for i, pos in enumerate(positions):
            if pos >= int(self.slot_pos[s]):
                raise ValueError(f"position {pos} not decoded yet")
            if pos < sess.blen:
                del_rows[:, :, i] = pos
            else:
                del_rows[:, :, i] = sess.phys_hist.pop(pos)
                if (int(self._pend_pos[s]) == pos
                        and self._pend_phys[0, s, 0] >= 0):
                    self._pend_phys[:, s] = -1    # never lands
        new_plans = []
        plan_rows = np.zeros_like(del_rows)
        for l in range(self.L):
            idxs = [del_rows[l, h] for h in range(self.Hkv)]
            pb = sess.plans[l].update(delete=idxs, policy="tombstone")
            for h in range(self.Hkv):
                plan_rows[l, h] = pb.hosts[h].inv[del_rows[l, h]]
            new_plans.append(pb)
        sess.plans = new_plans
        self._plan_gen[s] += 1                 # hosts were replaced:
        self.inserter.attach(s, new_plans,     # swap in a new generation
                             generation=self._plan_gen[s])
        _device_trim(self.pstate, plan_rows, s, self.bk)
        self.store.counters["deletes"] += del_rows.shape[-1]

    def rebucket(self, rid: int) -> None:
        """Force the rebucket tier on a live session: re-sort every member
        ordering by its maintained Morton codes (host), re-gather the
        slot's plan-ordered device rows to match. Shapes are untouched, so
        the decode signature holds."""
        sess = self.store.get(rid)
        if sess is None:
            raise KeyError(f"no live session {rid}")
        s = sess.slot
        self.store.counters["flushed_edges"] += self.inserter.flush(s)
        S = self.max_seq
        dev = self.device
        gathers = np.zeros((self.L, self.Hkv, S), np.int64)
        new_plans = []
        for l, pb in enumerate(sess.plans):
            cfg = pb.spec.config
            members = []
            for h, host in enumerate(pb.hosts):
                if host.codes is None:
                    codes, lo, hi = api._stream_codes(host, cfg, dev)
                    host.codes, host.code_lo, host.code_hi = codes, lo, hi
                r2, c2, v2 = host.coo
                pi2, inv2, r2n, c2n = api._stream_rebucket(
                    host.pi, host.codes, r2, c2, S)
                gathers[l, h] = host.inv[pi2]   # new plan row -> old row
                host.pi, host.inv = pi2, inv2
                host.coo = (r2n, c2n, v2)
                host.coo_dev = None
                host.tree = None
                host.gamma = None
                host.refresh = dataclasses.replace(
                    host.refresh, rebuckets=host.refresh.rebuckets + 1,
                    last_action="rebucket")
                members.append(api.InteractionPlan(
                    cfg, S, None, from_numpy(pi2, dev, torch.int64),
                    from_numpy(inv2, dev, torch.int64), host))
            new_plans.append(api.PlanBatch.from_plans(members, capacity=S))
        sess.plans = new_plans
        self._plan_gen[s] += 1
        self.inserter.attach(s, new_plans, generation=self._plan_gen[s])
        _device_regather(self.pstate, from_numpy(gathers, dev), s, self.bk)
        self.store.counters["rebuckets"] += 1

    # -- drain / snapshot / resume ------------------------------------------

    def snapshot(self, ckpt, step: int, name: str = "sessions",
                 blocking: bool = True) -> None:
        """Flush, pack every live session's device rows + request state
        into its ``aux`` payload, and hand the SessionStore to
        ``ckpt.save_plan(step, store, name=, blocking=)`` — a
        :class:`repro_torch.checkpoint.Checkpointer`, which gathers it to
        the host before returning; ``Checkpointer.restore_plan(name=)``
        gives the store back for :meth:`resume`."""
        self.store.counters["flushed_edges"] += self.inserter.flush_all()
        # bf16 has no npz representation: widen to float32 (lossless);
        # resume casts back to the cache dtype
        ks = to_numpy(self.pstate["ks"].float())
        vs = to_numpy(self.pstate["vs"].float())
        ps = to_numpy(self.pstate["ps"])
        cent = to_numpy(self.pstate["cent"])
        pend_k = to_numpy(self._pend_k.float())
        pend_v = to_numpy(self._pend_v.float())
        for sess in self.store.sessions.values():
            s = sess.slot
            req = self.slot_req[s]
            hist_pos = np.asarray(sorted(sess.phys_hist), np.int64)
            hist_phys = (np.stack([sess.phys_hist[int(p)] for p in hist_pos])
                         if hist_pos.size
                         else np.zeros((0, self.L, self.Hkv), np.int64))
            sess.aux = {
                "ks": ks[:, s], "vs": vs[:, s], "ps": ps[:, s],
                "cent": cent[:, s],
                "pend_k": pend_k[:, s], "pend_v": pend_v[:, s],
                "pend_phys": self._pend_phys[:, s].copy(),
                "pend_pos": np.asarray(self._pend_pos[s], np.int32),
                "slot_pos": np.asarray(self.slot_pos[s], np.int32),
                "prompt": np.asarray(req.tokens, np.int32),
                "output": np.asarray(req.output, np.int32),
                "max_new": np.asarray(req.max_new, np.int32),
                "eos_id": np.asarray(
                    -1 if req.eos_id is None else req.eos_id, np.int32),
                "hist_pos": hist_pos, "hist_phys": hist_phys,
            }
        ckpt.save_plan(step, self.store, name=name, blocking=blocking)

    def resume(self, store: SessionStore) -> None:
        """Adopt a restored SessionStore: rebind every session to its slot
        and rebuild the device state, pending token, and request from its
        ``aux`` payload. Decode continues bit-exactly."""
        if self.mode != "plan":
            raise ValueError("resume requires mode='plan'")
        self.store = store
        dev = self.device
        dt = self.pstate["ks"].dtype
        for sess in store.sessions.values():
            s, aux = sess.slot, sess.aux
            sess.phys_hist = {int(p): aux["hist_phys"][i]
                              for i, p in enumerate(aux["hist_pos"])}
            for key in ("ks", "vs", "ps", "cent"):
                self.pstate[key][:, s] = from_numpy(
                    aux[key], dev, dt if key in ("ks", "vs") else None)
            self._pend_k[:, s] = from_numpy(aux["pend_k"], dev, dt)
            self._pend_v[:, s] = from_numpy(aux["pend_v"], dev, dt)
            self._pend_phys[:, s] = aux["pend_phys"]
            self._pend_pos[s] = int(aux["pend_pos"])
            self.slot_pos[s] = int(aux["slot_pos"])
            eos = int(aux["eos_id"])
            req = Request(rid=sess.rid, tokens=np.asarray(aux["prompt"]),
                          max_new=int(aux["max_new"]),
                          eos_id=None if eos < 0 else eos,
                          output=[int(t) for t in aux["output"]])
            self.slot_req[s] = req
            self._slot_sess[s] = sess
            self._plan_gen[s] = 0              # restored plans: fresh
            self.inserter.attach(s, sess.plans, generation=0)

    # -- telemetry ----------------------------------------------------------

    def report(self) -> dict:
        """Machine-readable service telemetry (JSON-safe)."""
        rep = {
            "mode": self.mode, "backend": self.backend,
            "slots": self.slots, "max_seq": self.max_seq,
            "ticks": self.ticks, "tokens_out": self.tokens_out,
            "tokens_per_sec": (self.tokens_out / self._tick_time
                               if self._tick_time else 0.0),
            "decode_traces": self.decode_traces,
            "prefill_traces": len(self._pf_flash) + len(self._pf_plan),
            "host_claim_s": self._claim_time,
            "device_tick_s": self._device_time,
        }
        if self.mode == "plan":
            rep.update(self.store.report())
            tiers = dict(self._tier_totals)      # retired sessions
            for sess in self.store.sessions.values():
                for pb in sess.plans:
                    for host in pb.hosts:
                        for key in tiers:
                            tiers[key] += getattr(host.refresh, key, 0)
            rep["insert_tiers"] = tiers
        return rep
