"""The ClusterKV decode service (``repro_torch.serve``) against the reference
(``repro.serve``), on the CPU.

Setting of the reference's ``tests/test_serve.py``: the reduced Qwen config
in float32 with tiles of 32, ``MAX_SEQ = 128`` (4 tiles), and budgets that
cover every tile, so the plan decode is exact attention and its greedy
tokens must equal the flash engine's. The reference's parameters cross over
by ``convert.params_from_reference``. Host artifacts (Morton codes, claimed
slots, liveness, codes, coordinates, telemetry, COO indices) must be exact;
float tolerances are stated at each test. The reference's orderings differ
from the port's (ROADMAP C4, C9), so the inserter is held against the
reference on plans crossed over from it, and the whole service only where
the result does not depend on the ordering (covering budgets: the tokens).
Also here: the base ``Engine``'s edge cases that admission churn leans on,
and its ``_install`` hook returning replacement first-token logits.
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, stream_plan_from_reference, tn

from repro.configs import reduced_config as r_reduced
from repro.configs.base import ClusterKVConfig as RCKV
from repro.core import clusterkv as r_ckv
from repro.models import model_api as r_api
from repro.models import transformer as r_tf
from repro.models.sharding import NO_SHARD
from repro.serve import ClusterKVEngine as RService
from repro.serve import streaming as r_stream
from repro.train.serve_loop import Request as RRequest
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.core import clusterkv as t_ckv
from repro_torch.models import transformer as t_tf
from repro_torch.serve import ClusterKVEngine, Session, SessionStore
from repro_torch.serve import streaming as t_stream
from repro_torch.train.serve_loop import Engine, Request

MAX_SEQ = 128   # block_k 32 -> 4 tiles; decode_clusters 8 covers all of
                # them, so the sparse plan decode is EXACT
BIG = np.iinfo(np.int32).max


def _rcfg(clusters=8, dtype="float32"):
    return r_reduced("qwen2-0.5b").with_(
        dtype=dtype,
        clusterkv=RCKV(enabled=True, block_q=32, block_k=32,
                       blocks_per_query=8, decode_clusters=clusters))


@pytest.fixture(scope="module")
def model():
    rcfg = _rcfg()
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(0))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    return rcfg, rp, tcfg, tp


def _requests(cls, cfg, lengths, max_new=6, eos=None):
    rng = np.random.default_rng(7)
    return [cls(rid=i, tokens=rng.integers(1, cfg.vocab, n).astype(np.int32),
                max_new=max_new, eos_id=eos)
            for i, n in enumerate(lengths)]


def _service(cfg, params, slots=2, **kw):
    return ClusterKVEngine(cfg, params, slots=slots, max_seq=MAX_SEQ,
                           prefill_bucket=32, device="cpu", **kw)


def _engine(cfg, params, slots=2, max_seq=MAX_SEQ):
    return Engine(cfg, params, slots=slots, max_seq=max_seq,
                  prefill_bucket=32, device="cpu")


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs]


class MemoryCheckpointer:
    """In-memory stand-in for ``repro_torch.checkpoint.Checkpointer``:
    keeps a deep copy of what ``save_plan`` is handed, so the service's
    snapshot/resume is checked apart from the on-disk format."""

    def __init__(self):
        self.saved = {}

    def save_plan(self, step, plan, name="plan", blocking=False):
        self.saved[name] = (copy.deepcopy(plan), step)

    def restore_plan(self, name="plan"):
        plan, step = self.saved[name]
        return copy.deepcopy(plan), step


# ---------------------------------------------------------------------------
# the base Engine: the _install hook and the edge cases admission leans on
# ---------------------------------------------------------------------------


def test_engine_uses_the_logits_install_returns(model):
    """``_install`` may return replacement first-token logits: ``_admit``
    takes its first token from them and keeps them in ``first_logits``."""
    _, _, tcfg, tp = model

    class Override(Engine):
        def _install(self, s, req, cache_1, blen):
            super()._install(s, req, cache_1, blen)
            out = torch.zeros((1, tcfg.vocab))
            out[0, 17 + req.rid] = 1.0
            return out

    eng = Override(tcfg, tp, slots=2, max_seq=MAX_SEQ, prefill_bucket=32,
                   device="cpu")
    reqs = _requests(Request, tcfg, [20, 30], max_new=3)
    _serve(eng, reqs)
    for r in reqs:
        assert r.output[0] == 17 + r.rid
        assert int(eng.first_logits[r.rid].argmax()) == 17 + r.rid
    plain = _engine(tcfg, tp)
    ref = _requests(Request, tcfg, [20, 30], max_new=3)
    _serve(plain, ref)
    assert [r.output[0] for r in ref] == [
        int(plain.first_logits[r.rid].argmax()) for r in ref]


def test_engine_eos_on_last_active_slot(model):
    """EOS retiring the LAST active slot must free it and end the run
    cleanly (no spin on an engine with zero active slots)."""
    _, _, tcfg, tp = model
    eng = _engine(tcfg, tp)
    reqs = _requests(Request, tcfg, [20, 30], max_new=32)
    for r in reqs:
        eng.submit(r)
    eng.step()                          # both admitted + first decode
    reqs[0].eos_id = reqs[0].output[-1]
    eng._retire()
    assert eng.slot_req[0] is None and eng.slot_req[1] is not None
    reqs[1].eos_id = reqs[1].output[-1]  # EOS on the only active slot
    eng._retire()
    assert eng.slot_req == [None, None]
    ticks0 = eng.ticks
    eng.run()                           # nothing left: exit, no spinning
    assert eng.ticks == ticks0
    assert all(r.t_done > 0 for r in reqs)


def test_engine_queue_outnumbers_slots_fifo(model):
    """More queued requests than free slots: everything is served, and
    admission order is FIFO (first two finish before the last starts)."""
    _, _, tcfg, tp = model
    eng = _engine(tcfg, tp)
    reqs = _requests(Request, tcfg, [20, 25, 30, 18, 22], max_new=4)
    _serve(eng, reqs)
    for r in reqs:
        assert len(r.output) == 4, r.rid
    assert max(reqs[0].t_done, reqs[1].t_done) <= reqs[4].t_first


def test_engine_prefill_bucket_at_max_seq_boundary(model):
    """A prompt whose bucket rounds up to max_seq leaves no decode room:
    the engine must retire it promptly instead of looping or crashing."""
    _, _, tcfg, tp = model
    eng = _engine(tcfg, tp, slots=1, max_seq=64)
    req = _requests(Request, tcfg, [50], max_new=8)[0]  # bucket 64 == max
    eng.submit(req)
    eng.run(max_ticks=20)
    assert req.t_done > 0
    assert len(req.output) < 8       # cut off by the max_seq guard
    assert eng.slot_req == [None]


def test_engine_retire_then_backfill_same_tick(model):
    """With one slot and max_new=2, each request needs exactly one decode
    tick; the freed slot must be re-filled on the very next tick."""
    _, _, tcfg, tp = model
    eng = _engine(tcfg, tp, slots=1)
    reqs = _requests(Request, tcfg, [20, 24], max_new=2)
    _serve(eng, reqs)
    assert [len(r.output) for r in reqs] == [2, 2]
    assert eng.ticks == 2            # no idle tick between the two


# ---------------------------------------------------------------------------
# streaming building blocks, exact on the same numpy inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3])
def test_morton_codes_boxes_match_reference(d):
    rng = np.random.default_rng(d)
    y = rng.standard_normal((3, 4, 2, d)).astype(np.float32)
    lo = (rng.standard_normal((3, 4, 2, d)) - 1.5).astype(np.float32)
    hi = lo + rng.uniform(0.5, 3.0, (3, 4, 2, d)).astype(np.float32)
    got = t_stream.morton_codes_boxes(y, lo, hi, 10)
    want = r_stream.morton_codes_boxes(y, lo, hi, 10)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


class _Host:
    __slots__ = ("pi", "codes", "alive")


def _claim_members(rng, cap, m, occupancy):
    codes_io = rng.integers(0, 1 << 30, (m, cap)).astype(np.uint64)
    codes_io.sort(axis=1)
    alive_io = rng.random((m, cap)) < occupancy
    hosts, pis = [], np.zeros((m, cap), np.int64)
    for i in range(m):
        h = _Host()
        h.pi = rng.permutation(cap)
        h.codes = np.empty(cap, np.uint64)
        h.codes[h.pi] = codes_io[i]
        h.alive = np.empty(cap, bool)
        h.alive[h.pi] = alive_io[i]
        hosts.append(h)
        pis[i] = h.pi
    return codes_io, alive_io, hosts, pis


@pytest.mark.parametrize("cap,m,ticks,window_miss", [
    (64, 6, 12, False),            # one level (C < 2 * CLAIM_BLOCK)
    (256, 4, 20, False),           # two-level search
    (512, 8, 8, False),
    (512, 4, 3, True)])            # no free slot within +-128 of the target
def test_claims_match_reference(cap, m, ticks, window_miss):
    """``claim_slot`` and ``claim_slots_batched`` give the reference's
    claims exactly under tick churn, with and without the maintained block
    maxima, and the batched claims equal the per-member loop."""
    rng = np.random.default_rng(cap + m)
    codes_io, alive_io, hosts, pis = _claim_members(
        rng, cap, m, rng.uniform(0.1, 0.9))
    if window_miss:
        alive_io[:] = True
        alive_io[:, :4] = False            # free slots only at the front
        for i, h in enumerate(hosts):
            h.alive[h.pi] = alive_io[i]
    bs = t_stream.CLAIM_BLOCK
    assert bs == r_stream.CLAIM_BLOCK
    use_bm = cap % bs == 0 and cap >= 2 * bs
    bm = codes_io.reshape(m, -1, bs).max(axis=2) if use_bm else None
    rows = np.arange(m)
    for _ in range(ticks):
        arr = rng.integers(0, 1 << 30, (m,)).astype(np.uint64)
        if window_miss:
            arr[:] = codes_io[:, -1]       # targets at the far end
        want = np.array([r_stream.claim_slot(h, arr[i])
                         for i, h in enumerate(hosts)])
        got = np.array([t_stream.claim_slot(h, arr[i])
                        for i, h in enumerate(hosts)])
        np.testing.assert_array_equal(got, want)
        for block_max in (None, bm):
            pos = t_stream.claim_slots_batched(codes_io, alive_io, arr,
                                               block_max=block_max)
            ref = r_stream.claim_slots_batched(codes_io, alive_io, arr,
                                               block_max=block_max)
            np.testing.assert_array_equal(pos, ref)
            assert (pis[rows, pos] == want).all()
        for i, h in enumerate(hosts):       # churn, as the inserter does
            h.alive[want[i]] = True
            h.codes[want[i]] = arr[i]
        alive_io[rows, pos] = True
        codes_io[rows, pos] = arr
        if use_bm:
            blk = pos // bs
            seg = codes_io[rows[:, None], (blk * bs)[:, None]
                           + np.arange(bs)]
            bm[rows, blk] = seg.max(axis=1)
        if window_miss and not (~alive_io).any(axis=1).all():
            break
    full = np.ones((2, 32), bool)
    for mod in (t_stream, r_stream):
        with pytest.raises(ValueError, match="no free plan slots"):
            mod.claim_slots_batched(np.zeros((2, 32), np.uint64), full,
                                    np.zeros(2, np.uint64))
    h = _Host()
    h.pi, h.codes, h.alive = np.arange(4), np.zeros(4, np.uint64), \
        np.ones(4, bool)
    with pytest.raises(ValueError, match="no free plan slots"):
        t_stream.claim_slot(h, np.uint64(3))


# ---------------------------------------------------------------------------
# plan_decode_step
# ---------------------------------------------------------------------------


def _plan_state(seed, L, B, H, S, dh, bk, live):
    """Plan-ordered caches: per (layer, slot, head) a random permutation of
    plan rows, positions 0..live[b]-1 alive, the rest holes (zero rows,
    INT32_MAX)."""
    rng = np.random.default_rng(seed)
    ks = rng.standard_normal((L, B, H, S, dh)).astype(np.float32)
    vs = rng.standard_normal((L, B, H, S, dh)).astype(np.float32)
    ps = np.stack([np.stack([np.stack([rng.permutation(S)
                                       for _ in range(H)])
                             for _ in range(B)]) for _ in range(L)])
    for b in range(B):
        hole = ps[:, b] >= live[b]
        ps[:, b][hole] = BIG
        ks[:, b][hole] = 0.0
        vs[:, b][hole] = 0.0
    return ks, vs, ps.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_decode_step_matches_reference(model, dtype):
    """One tick on the same state: slot 0 has a pending token at a hole
    in most lanes and none in two; slot 1 has none. The landed ``ks/vs``
    rows and ``ps`` are exact and every lane at the sentinel leaves its
    ``ks/vs/ps/cent`` bit-equal. float32: ``cent`` within rtol 1e-6
    (a mean of 32 rows, summed in another order), logits, ``k_new`` and
    ``v_new`` within rtol 1e-5 (``_torch_parity.TOL``). bfloat16: the layers
    round to 8 significant bits at different points in the two packages
    (and the reference's group mean is taken in bf16, ROADMAP C13), so
    ``k_new``/``v_new`` within 2 bf16 spacings (2 x 2^-8 relative) and the
    logits within 2e-2 x max|logits|; the landing is still exact."""
    _, rp, _, _ = model
    rcfg = _rcfg(clusters=2, dtype=dtype)       # 2 of 4 tiles: selective
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    L, B, H, S, dh, bk = (rcfg.n_layers, 2, rcfg.n_kv_heads, MAX_SEQ,
                          rcfg.head_dim, 32)
    live = [80, 60]
    ks, vs, ps = _plan_state(11, L, B, H, S, dh, bk, live)
    jdt, tdt = jnp.dtype(dtype), t_tf.DTYPES[dtype]
    # centroids: float32 tile means of the keys as the cache holds them
    cent = tn(torch.from_numpy(ks).to(tdt).float().reshape(
        L, B, H, S // bk, bk, dh).mean(4))
    rng = np.random.default_rng(12)
    slot = np.full((L, B, H), S, np.int32)
    for l in range(L):
        for h in range(H):
            slot[l, 0, h] = int(rng.choice(np.nonzero(ps[l, 0, h] == BIG)[0]))
    slot[0, 0, 1] = slot[1, 0, 0] = S            # sentinel lanes in slot 0
    pk = rng.standard_normal((L, B, H, dh)).astype(np.float32)
    pv = rng.standard_normal((L, B, H, dh)).astype(np.float32)
    ppos = np.array([live[0], live[1] - 1], np.int32)
    qpos = np.array([live[0] + 1, live[1]], np.int32)
    tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)

    rstate = {"ks": jnp.asarray(ks, jdt), "vs": jnp.asarray(vs, jdt),
              "ps": jnp.asarray(ps), "cent": jnp.asarray(cent)}
    rpend = {"k": jnp.asarray(pk, jdt), "v": jnp.asarray(pv, jdt),
             "slot": jnp.asarray(slot), "pos": jnp.asarray(ppos)}
    want, wstate, wk, wv = r_tf.plan_decode_step(
        rp, rcfg, rstate, rpend, jnp.asarray(tok), jnp.asarray(qpos),
        NO_SHARD)
    tstate = {"ks": torch.from_numpy(ks).to(tdt),
              "vs": torch.from_numpy(vs).to(tdt),
              "ps": torch.from_numpy(ps), "cent": torch.from_numpy(cent)}
    before = {k: v.clone() for k, v in tstate.items()}
    tpend = {"k": torch.from_numpy(pk).to(tdt),
             "v": torch.from_numpy(pv).to(tdt),
             "slot": torch.from_numpy(slot), "pos": torch.from_numpy(ppos)}
    got, gstate, gk, gv = t_tf.plan_decode_step(
        tp, tcfg, tstate, tpend, torch.from_numpy(tok),
        torch.from_numpy(qpos))
    assert gstate is tstate                      # written in place

    f32 = {k: tn(v.float()) if v.is_floating_point() else tn(v)
           for k, v in gstate.items()}
    ref = {k: np.asarray(v.astype(jnp.float32)) if k in ("ks", "vs")
           else np.asarray(v) for k, v in wstate.items()}
    np.testing.assert_array_equal(f32["ps"], ref["ps"])
    np.testing.assert_array_equal(f32["ks"], ref["ks"])
    np.testing.assert_array_equal(f32["vs"], ref["vs"])
    pending = slot < S
    for l, b, h in zip(*np.nonzero(pending)):
        assert f32["ps"][l, b, h, slot[l, b, h]] == ppos[b]
    for l, b, h in zip(*np.nonzero(~pending)):
        for key in ("ks", "vs", "ps", "cent"):
            assert torch.equal(gstate[key][l, b, h], before[key][l, b, h])
    np.testing.assert_allclose(f32["cent"], ref["cent"], rtol=1e-6,
                               atol=1e-7)
    if dtype == "float32":
        assert_close(got, want)
        assert_close(gk, wk)
        assert_close(gv, wv)
    else:
        for g, w in ((gk, wk), (gv, wv)):
            w = np.asarray(w.astype(jnp.float32))
            np.testing.assert_allclose(tn(g.float()), w, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(w).max())
        w = np.asarray(want)
        np.testing.assert_allclose(tn(got), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())


# ---------------------------------------------------------------------------
# the lockstep inserter on plans crossed over from the reference
# ---------------------------------------------------------------------------


def _ref_plans(keys, cap):
    """One reference ``kv_plan_batch`` per (layer, slot) over ``keys``
    (L, B, H, s, dh)."""
    return [[r_ckv.kv_plan_batch(jnp.asarray(keys[l, b]), knn=8,
                                 capacity=cap)
             for b in range(keys.shape[1])] for l in range(keys.shape[0])]


def _cross(pb):
    return t_api.PlanBatch.from_plans(
        [stream_plan_from_reference(pb.member(i)) for i in range(pb.batch)],
        capacity=pb.capacity)


def test_lockstep_inserter_matches_reference():
    """Three ticks across two slots: the claimed physical rows, each
    member's ``alive``, ``codes``, ``x``, ``peak_alive`` and refresh
    telemetry are exact, and the flushed COO has exact indices and values
    within rtol 1e-5. The arrivals' embedding ``(k - mean) @ axes`` is a
    float32 product summed in another order than XLA's, so the rows the
    inserter writes into ``embedding`` agree within rtol 1e-6 (a few
    ulps; ROADMAP C18); on these inputs no arrival sits that close to a
    Morton cell edge, so the codes, and with them the claims, are equal."""
    L, B, H, s, cap, dh = 2, 2, 2, 48, 256, 16
    rng = np.random.default_rng(21)
    keys = rng.standard_normal((L, B, H, s, dh)).astype(np.float32)
    new = rng.standard_normal((3, L, B, H, dh)).astype(np.float32)
    ref_plans = _ref_plans(keys, cap)
    ours = [[_cross(pb) for pb in row] for row in _ref_plans(keys, cap)]
    r_ins = r_stream.LockstepInserter(L, B, H, cap, dh, 3, 8)
    t_ins = t_stream.LockstepInserter(L, B, H, cap, dh, 3, 8, device="cpu")
    for b in range(B):
        r_ins.attach(b, [ref_plans[l][b] for l in range(L)])
        t_ins.attach(b, [ours[l][b] for l in range(L)])
    for t in range(3):
        want = r_ins.insert([0, 1], jnp.asarray(new[t]))
        got = t_ins.insert([0, 1], torch.from_numpy(new[t]))
        np.testing.assert_array_equal(got, want)
        for l in range(L):
            for b in range(B):
                for rh, th in zip(ref_plans[l][b].hosts, ours[l][b].hosts):
                    for name in ("alive", "codes", "x"):
                        np.testing.assert_array_equal(
                            getattr(th, name), getattr(rh, name), name)
                    np.testing.assert_allclose(th.embedding, rh.embedding,
                                               rtol=1e-6, atol=1e-7)
                    assert th.peak_alive == rh.peak_alive
                    np.testing.assert_array_equal(th.last_inserted_idx,
                                                  rh.last_inserted_idx)
                    assert dataclasses.asdict(th.refresh) == \
                        dataclasses.asdict(rh.refresh)
    assert t_ins.flush_all() == r_ins.flush_all() == 3 * L * B * H * 8
    for l in range(L):
        for b in range(B):
            for rh, th in zip(ref_plans[l][b].hosts, ours[l][b].hosts):
                for a, w in zip(th.coo[:2], rh.coo[:2]):
                    np.testing.assert_array_equal(a, w)
                np.testing.assert_allclose(th.coo[2], rh.coo[2], rtol=1e-5)


def test_inserter_claims_equal_plan_batch_insert():
    """The inserter's Morton-leaf claim lands each key exactly where the
    port's own ``PlanBatch.insert`` (``update_plan``'s insert tier) does."""
    H, s, cap, dh = 2, 32, 64, 16
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.normal(size=(H, s, dh)).astype(np.float32))
    new = rng.normal(size=(H, dh)).astype(np.float32)
    pb_ref = t_ckv.kv_plan_batch(keys, knn=8, capacity=cap)
    _, idx_ref = pb_ref.insert([new[h][None] for h in range(H)])
    pb = t_ckv.kv_plan_batch(keys, knn=8, capacity=cap)
    ins = t_stream.LockstepInserter(n_layers=1, slots=1, n_heads=H,
                                    capacity=cap, head_dim=dh, embed_d=3,
                                    knn=8, device="cpu")
    ins.attach(0, [pb])
    phys = ins.insert([0], torch.from_numpy(new[None, None]))
    for h in range(H):
        assert phys[0, 0, h] == idx_ref[h][0], h
        host = pb.hosts[h]
        assert bool(host.alive[phys[0, 0, h]])
        assert host.refresh.appends == 1
    assert ins.flush(0) > 0


def test_inserter_stale_generation_raises():
    """An insert streamed against a stale attachment raises instead of
    mutating hosts the serving plan no longer reads."""
    rng = np.random.default_rng(9)
    H, s, cap, dh = 2, 32, 64, 16
    keys = torch.from_numpy(rng.normal(size=(H, s, dh)).astype(np.float32))
    pb = t_ckv.kv_plan_batch(keys, knn=8, capacity=cap)
    ins = t_stream.LockstepInserter(n_layers=1, slots=1, n_heads=H,
                                    capacity=cap, head_dim=dh, embed_d=3,
                                    knn=8, device="cpu")
    ins.attach(0, [pb], generation=2)
    assert ins.generation(0) == 2
    new = torch.from_numpy(rng.normal(size=(1, 1, H, dh)).astype(np.float32))
    ins.insert([0], new, generations={0: 2})        # in sync: fine
    with pytest.raises(RuntimeError, match="re-attach after a plan swap"):
        ins.insert([0], new, generations={0: 3})    # plans swapped since
    with pytest.raises(ValueError, match="no attached session"):
        ins.detach(0)
        ins.insert([0], new)


def test_session_store_bookkeeping():
    """Spec-keyed membership + counters, without any engine."""
    store = SessionStore()

    class _Plan:        # stand-in with a hashable spec
        spec = ("cfg", 64)

    s1 = Session(rid=1, slot=0, blen=32, plans=[_Plan()])
    s2 = Session(rid=2, slot=1, blen=64, plans=[_Plan()])
    assert store.admit(s1) is True            # first spec sighting
    assert store.admit(s2) is False           # shared spec
    assert store.specs_live == 1 and store.specs_seen == 1
    store.retire(1)
    assert store.specs_live == 1              # rid 2 still holds the spec
    store.retire(2, evict=True)
    assert store.specs_live == 0 and store.specs_seen == 1
    assert store.register(s1) is False        # restore path: no admission
    rep = store.report()
    assert rep["counters"]["admits"] == 2
    assert rep["counters"]["retires"] == 1
    assert rep["counters"]["evictions"] == 1
    assert rep["active_sessions"] == 1 and store.get(1) is s1


# ---------------------------------------------------------------------------
# the service, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan_prefill", [False, True])
def test_service_matches_flash_engine_and_reference(model, plan_prefill):
    """Plan-cached service decode == the port's flash engine == the
    reference's service, token for token, across slot churn and mixed
    prompt lengths (covering budgets: exact attention)."""
    rcfg, rp, tcfg, tp = model
    lengths = [20, 35, 17, 40]
    flash = _serve(_engine(tcfg, tp), _requests(Request, tcfg, lengths))
    svc = _service(tcfg, tp, plan_prefill=plan_prefill)
    got = _serve(svc, _requests(Request, tcfg, lengths))
    ref = RService(rcfg, rp, slots=2, max_seq=MAX_SEQ, prefill_bucket=32,
                   mode="plan", plan_prefill=plan_prefill)
    want = _serve(ref, _requests(RRequest, rcfg, lengths))
    assert got == flash
    assert got == want
    rep, rrep = svc.report(), ref.report()
    assert rep["decode_traces"] == rrep["decode_traces"] == 1
    assert rep["counters"] == rrep["counters"]
    assert rep["insert_tiers"] == rrep["insert_tiers"]
    assert rep["prefill_traces"] == rrep["prefill_traces"]


def test_service_one_spec_one_decode_signature(model):
    """Admissions across different prefill buckets all re-unify to one
    PlanSpec and re-enter ONE decode signature."""
    _, _, tcfg, tp = model
    svc = _service(tcfg, tp)
    _serve(svc, _requests(Request, tcfg, [20, 40, 60, 25, 50, 33]))
    rep = svc.report()
    assert rep["counters"]["admits"] == 6
    assert rep["specs_seen"] == 1, "admission retriggered spec derivation"
    assert rep["decode_traces"] == 1, "admission changed the decode shapes"
    assert rep["prefill_traces"] == 2          # buckets 32 and 64
    assert len(svc.timings["tick_s"]) == rep["ticks"]
    assert rep["device_tick_s"] > 0 and rep["host_claim_s"] > 0


def test_service_insert_tier_telemetry(model):
    """Every generated token streams through the append tier of every
    (layer, head) member plan; the kNN edges are folded on retire."""
    _, _, tcfg, tp = model
    svc = _service(tcfg, tp)
    reqs = _requests(Request, tcfg, [20, 30], max_new=5)
    _serve(svc, reqs)
    rep = svc.report()
    members = tcfg.n_layers * tcfg.n_kv_heads
    inserts = sum(len(r.output) - 1 for r in reqs)
    assert rep["counters"]["inserts"] == inserts
    assert rep["insert_tiers"]["appends"] == inserts * members
    assert rep["counters"]["flushed_edges"] == inserts * members * svc.knn


def test_service_trim_tombstones(model):
    """Trimming live positions takes the tombstone tier (the decode
    signature holds), the device rows are re-holed, and decode goes on."""
    _, _, tcfg, tp = model
    svc = _service(tcfg, tp, slots=1)
    req = _requests(Request, tcfg, [20], max_new=10)[0]
    svc.submit(req)
    for _ in range(4):
        svc.step()
    sess = svc.store.get(req.rid)
    gen_pos = sorted(sess.phys_hist)[0]       # an already-landed token
    svc.trim(req.rid, [3, gen_pos, 3])        # one prompt + one generated
    assert svc.store.counters["deletes"] == 2
    for pb in sess.plans:
        for host in pb.hosts:
            assert host.refresh.tombstones == 1
            assert host.refresh.deleted_total == 2
    ps = svc.pstate["ps"][:, 0]
    assert not ((ps == 3) | (ps == gen_pos)).any()
    with pytest.raises(ValueError, match="not decoded yet"):
        svc.trim(req.rid, [10_000])
    with pytest.raises(KeyError):
        svc.trim(99, [1])
    svc.run()
    assert len(req.output) == 10
    assert svc.report()["decode_traces"] == 1


def test_service_rebucket_keeps_decode_exact(model):
    """Rebucketing mid-decode only reorders the plan rows; with a
    covering budget the remaining tokens are unchanged."""
    _, _, tcfg, tp = model
    ref = _requests(Request, tcfg, [24], max_new=10)[0]
    _serve(_service(tcfg, tp, slots=1), [ref])
    req = _requests(Request, tcfg, [24], max_new=10)[0]
    e1 = _service(tcfg, tp, slots=1)
    e1.submit(req)
    for _ in range(4):
        e1.step()
    e1.rebucket(req.rid)
    assert e1.store.counters["rebuckets"] == 1
    assert e1.report()["insert_tiers"]["rebuckets"] == tcfg.n_layers * \
        tcfg.n_kv_heads
    e1.run()
    assert req.output == ref.output
    assert e1.report()["decode_traces"] == 1


@pytest.mark.parametrize("store", ["memory", "disk"])
def test_service_snapshot_resume_bit_exact(model, store, tmp_path):
    """Drain -> save_plan(SessionStore) -> restore -> resume continues
    decode bit-exactly in a FRESH engine, counters kept: through the
    in-memory stand-in and through the on-disk ``Checkpointer``."""
    from repro_torch.checkpoint import Checkpointer

    _, _, tcfg, tp = model
    lengths = [20, 30]
    ref = _requests(Request, tcfg, lengths, max_new=10)
    _serve(_service(tcfg, tp), ref)
    e1 = _service(tcfg, tp)
    for r in _requests(Request, tcfg, lengths, max_new=10):
        e1.submit(r)
    for _ in range(4):
        e1.step()
    if store == "memory":
        ck = MemoryCheckpointer()
        e1.snapshot(ck, step=4)
        store, step = ck.restore_plan(name="sessions")
    else:
        ck = Checkpointer(tmp_path)
        e1.snapshot(ck, step=4, blocking=False)
        ck.wait()
        store, step = ck.restore_plan(name="sessions", device="cpu")
    assert step == 4
    assert sorted(store.sessions) == [0, 1]
    assert store.counters == e1.store.counters
    e2 = _service(tcfg, tp)
    e2.resume(store)
    restored = {r.rid: r for r in e2.slot_req if r is not None}
    for s in range(2):
        for key in ("ks", "vs", "ps", "cent"):
            assert torch.equal(e2.pstate[key][:, s], e1.pstate[key][:, s])
    e2.run()
    for a in ref:
        assert restored[a.rid].output == a.output, a.rid
    assert e2.store.counters["admits"] == 2
    assert e2.report()["decode_traces"] == 1


def test_idle_slot_state_stays_bit_equal(model):
    """A tick with nothing pending on a slot (the sentinel lanes) leaves
    that slot's ``ks/vs/ps/cent`` bit-equal: one request on two slots."""
    _, _, tcfg, tp = model
    svc = _service(tcfg, tp)
    req = _requests(Request, tcfg, [30], max_new=6)[0]
    svc.submit(req)
    svc.step()
    idle = {k: v[:, 1].clone() for k, v in svc.pstate.items()}
    while svc.slot_req[0] is not None:
        svc.step()
        svc._retire()
    for key, want in idle.items():
        assert torch.equal(svc.pstate[key][:, 1], want), key


def test_service_rejects_what_it_cannot_serve(model):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="unknown service mode"):
        _service(tcfg, tp, mode="fast")
    svc = _service(tcfg, tp, mode="percall")
    assert svc.backend == "clusterkv"
    with pytest.raises(ValueError, match="resume requires"):
        svc.resume(SessionStore())
    got = _serve(svc, _requests(Request, tcfg, [20, 35]))
    assert all(len(o) == 6 for o in got)
    assert svc.report()["decode_traces"] == 1


def test_twin_example_on_the_cpu():
    """``examples/serve_clusterkv_torch.py`` keeps every assertion of
    ``examples/serve_clusterkv.py``."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable,
                        str(root / "examples" / "serve_clusterkv_torch.py"),
                        "--device", "cpu"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "service tokens match dense decode" in r.stdout
