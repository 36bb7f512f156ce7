"""The double-buffered plan (``repro_torch.core.doublebuf``): the port's
twins of the ``test_doublebuffer_*`` cases of ``tests/test_streaming.py``,
a worker exception re-raised at ``poll``, and one update sequence run
through both packages' ``DoubleBufferedPlan`` on the same carried plan.

The background repair is gated by replacing ``api.apply_pending_layout``
(``monkeypatch``): the worker reads it from the module when it launches,
so the test holds the build open while it serves and queues.

Against the reference: a rebucket swap is exact (the same codes sort the
same slots: ``pi``, ``col_idx``, ``nbr_mask`` equal, ``vals`` at float32
``rtol 1e-5``); a compaction is a fresh build in each package, whose PCA
start differs (ROADMAP C4), so after it the ordering-independent results
are compared — ``compact_map`` exactly, the pattern in original order and
the original-order products at float32 tolerance. The points are wide
clusters (``spread=1.0``), away from the kNN near-ties of ROADMAP C17.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, stream_plan_from_reference, tn, tt

from repro import api as ref_api
from repro.core.doublebuf import DoubleBufferedPlan as RefDBP
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch.core.doublebuf import DoubleBufferedPlan

N, D, K = 512, 32, 8
CPU = "cpu"


def _fresh_points(m, seed, spread=0.15):
    return feature_mixture(max(m, 8), D, n_clusters=8, seed=seed,
                           spread=spread)[:m]


@pytest.fixture(scope="module")
def points():
    return feature_mixture(N, D, n_clusters=8, seed=0)


def _gate(monkeypatch):
    """Hold every background repair until the returned event is set."""
    gate = threading.Event()
    real = t_api.apply_pending_layout

    def gated(p):
        assert gate.wait(60), "the test never opened the gate"
        return real(p)

    monkeypatch.setattr(t_api, "apply_pending_layout", gated)
    return gate, real


def _join(dbp):
    t = dbp._thread
    if t is not None:
        t.join(60)
        assert not t.is_alive()


def test_doublebuffer_midbuild_matvec_is_old_generation(points, monkeypatch):
    plan = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, capacity=N + 64, gamma_tol=1e-4,
                            device=CPU)
    _ = plan.gamma                       # arm the drift guard
    gate, real = _gate(monkeypatch)
    dbp = DoubleBufferedPlan(plan)
    rng = np.random.default_rng(14)
    step = 0
    while not dbp.building:
        assert step < 20, "expected the gamma guard to defer a rebucket"
        kill = rng.choice(np.nonzero(dbp.plan.alive)[0], 8, replace=False)
        assert dbp.update(insert=_fresh_points(8, seed=20 + step),
                          delete=kill) == "applied"
        step += 1
    snap = dbp.plan
    assert snap.host.pending_layout == "rebucket"
    xv = tt(rng.standard_normal(snap.n).astype(np.float32))
    y0 = snap.matvec(xv)
    # updates arriving mid-build queue; the serving buffer is frozen, so
    # a mid-build matvec returns the old generation's result bit-exactly
    assert dbp.update(insert=_fresh_points(4, seed=99)) == "queued"
    assert dbp.plan is snap and dbp.queued == 1
    assert torch.equal(dbp.matvec(xv), y0)
    assert torch.equal(dbp.apply(snap.permute(xv)), snap.apply(
        snap.permute(xv)))
    gen0 = dbp.generation
    gate.set()
    dbp.wait()
    assert dbp.generation == gen0 + 1
    assert dbp.queued == 0               # the queued insert replayed
    # the swapped-in successor is bit-identical to running the same
    # repair synchronously on the snapshot
    snapshot, successor, kind = dbp.last_swap
    assert kind == "rebucket" and snapshot is snap
    redo = real(snapshot)
    for name in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(successor.bsr, name),
                           getattr(redo.bsr, name)), name
    assert torch.equal(successor.pi, redo.pi)
    assert dbp.events[-1][0] == "apply"  # the replayed insert
    assert dbp.events[-2] == ("swap", "rebucket", None)
    final = dbp.flush()
    assert final.host.pending_layout is None and not dbp.building


def test_doublebuffer_compact_swap_remaps_queued_deletes(points,
                                                         monkeypatch):
    plan = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, device=CPU)
    gate, _ = _gate(monkeypatch)
    dbp = DoubleBufferedPlan(plan)
    rng = np.random.default_rng(15)
    kill = rng.choice(N, int(0.30 * N), replace=False)
    assert dbp.update(delete=kill) == "applied"
    assert dbp.building                  # compact launched in background
    live = np.nonzero(dbp.plan.alive)[0]
    assert dbp.update(delete=live[:10]) == "queued"
    gate.set()
    final = dbp.flush()
    # the compact renumbered the physical slots; the queued delete was
    # remapped through compact_map and applied cleanly after the swap
    assert final.n_alive == N - kill.size - 10
    swaps = [e for e in dbp.events if e[0] == "swap"]
    assert swaps and swaps[0][1] == "compact" and swaps[0][2] is not None
    cmap = swaps[0][2]
    assert not final.alive[cmap[live[:10]]].any()
    assert (cmap[kill] == -1).all()


def test_doublebuffer_worker_exception_is_raised_at_poll(points,
                                                         monkeypatch):
    """A repair that fails is never swallowed: ``poll`` (and with it
    ``update``/``wait``) re-raises it once, and the serving plan stays
    the snapshot, still serving."""
    plan = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, device=CPU)

    class RepairFailed(RuntimeError):
        pass

    started = threading.Event()

    def broken(p):
        started.set()
        raise RepairFailed("layout repair failed")

    monkeypatch.setattr(t_api, "apply_pending_layout", broken)
    dbp = DoubleBufferedPlan(plan)
    kill = np.random.default_rng(16).choice(N, int(0.30 * N), replace=False)
    assert dbp.update(delete=kill) == "applied"
    assert started.wait(60)
    _join(dbp)
    snap = dbp.plan
    with pytest.raises(RepairFailed, match="layout repair failed"):
        dbp.poll()
    assert dbp.poll() is False           # raised once, then cleared
    assert dbp.plan is snap and dbp.generation == 0
    assert not [e for e in dbp.events if e[0] == "swap"]
    xv = tt(np.ones(snap.n, np.float32))
    assert torch.equal(dbp.matvec(xv), snap.matvec(xv))
    # the next layout tier launches again, and a failure surfaces through
    # update as well
    live = np.nonzero(dbp.plan.alive)[0]
    started.clear()
    assert dbp.update(delete=live[:4]) == "applied"
    assert started.wait(60)
    _join(dbp)
    with pytest.raises(RepairFailed):
        dbp.update(delete=live[4:8])


def _assert_same_layout(t, r):
    np.testing.assert_array_equal(t.host.pi, np.asarray(r.host.pi))
    np.testing.assert_array_equal(t.alive, np.asarray(r.alive))
    for name in ("col_idx", "nbr_mask"):
        np.testing.assert_array_equal(tn(getattr(t.bsr, name)),
                                      np.asarray(getattr(r.bsr, name)))
    assert_close(t.bsr.vals, r.bsr.vals, rtol=1e-5, atol=1e-6)


def _orig_edges(p):
    r, c, v = p.coo
    pi = np.asarray(p.host.pi)
    key = pi[r].astype(np.int64) * p.n + pi[c]
    order = np.argsort(key)
    return key[order], np.asarray(v)[order]


def _kinds(events):
    return [e[:2] if e[0] == "swap" else e[0] for e in events]


def _assert_same_products(t, r, seed):
    x = np.random.default_rng(seed).standard_normal(
        (r.n, 2)).astype(np.float32)
    want = np.asarray(r.matvec(jnp.asarray(x), backend="bsr"))
    assert_close(t.matvec(tt(x)), want,
                 atol=1e-5 * max(float(np.abs(want).max()), 1.0))


def test_doublebuffer_matches_the_reference(monkeypatch):
    """One update sequence through both packages' double buffers on the
    same carried plan: the same answers (applied / queued), the same
    events, and successors alike — a rebucket swap exactly, a compact
    swap in its ordering-independent results."""
    x = feature_mixture(N, D, n_clusters=8, seed=0, spread=1.0)
    rp = ref_api.build_plan(x, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, capacity=N + 64, gamma_tol=1e-4)
    _ = rp.gamma
    tp = stream_plan_from_reference(rp)
    _ = tp.gamma
    gates = {}
    for name, mod in (("port", t_api), ("ref", ref_api)):
        gate = threading.Event()
        real = mod.apply_pending_layout
        gates[name] = gate

        def gated(p, real=real, gate=gate):
            assert gate.wait(60)
            return real(p)

        monkeypatch.setattr(mod, "apply_pending_layout", gated)
    tb, rb = DoubleBufferedPlan(tp), RefDBP(rp)
    rng = np.random.default_rng(17)

    def both(**kw):
        got, want = tb.update(**kw), rb.update(**kw)
        assert got == want
        return got

    # in-place steps until the γ guard defers a rebucket
    step = 0
    while not rb.building:
        assert step < 20
        kill = rng.choice(np.nonzero(np.asarray(rb.plan.alive))[0], 8,
                          replace=False)
        assert both(insert=_fresh_points(8, 40 + step, spread=1.0),
                    delete=kill) == "applied"
        step += 1
    assert tb.building and tb.plan.host.pending_layout == "rebucket"
    _assert_same_layout(tb.plan, rb.plan)
    kill = rng.choice(np.nonzero(np.asarray(rb.plan.alive))[0], 6,
                      replace=False)
    assert both(delete=kill) == "queued"
    for g in gates.values():
        g.set()
    tb.wait()
    rb.wait()
    assert tb.generation == rb.generation == 1
    assert _kinds(tb.events) == _kinds(rb.events)
    assert tb.last_swap[2] == rb.last_swap[2] == "rebucket"
    _assert_same_layout(tb.last_swap[1], rb.last_swap[1])
    _assert_same_layout(tb.plan, rb.plan)
    for g in gates.values():
        g.clear()

    # deletes past max_dead_frac: a compaction builds in the background
    live = np.nonzero(np.asarray(rb.plan.alive))[0]
    kill = rng.choice(live, int(0.30 * live.size), replace=False)
    assert both(delete=kill) == "applied"
    assert tb.building and rb.building
    live = np.nonzero(np.asarray(rb.plan.alive))[0]
    assert both(delete=live[:10]) == "queued"
    for g in gates.values():
        g.set()
    final_t, final_r = tb.flush(), rb.flush()
    assert tb.generation == rb.generation
    assert _kinds(tb.events) == _kinds(rb.events)
    for et, er in zip(tb.events, rb.events):
        if et[0] == "apply":
            a, b = et[1], er[1]
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
        elif et[2] is not None or er[2] is not None:
            np.testing.assert_array_equal(et[2], np.asarray(er[2]))
    assert final_t.n == final_r.n and final_t.n_alive == final_r.n_alive
    np.testing.assert_array_equal(final_t.alive, np.asarray(final_r.alive))
    kt, vt = _orig_edges(final_t)
    kr, vr = _orig_edges(final_r)
    np.testing.assert_array_equal(kt, kr)
    assert_close(vt, vr, rtol=1e-5, atol=1e-6)
    _assert_same_products(final_t, final_r, seed=18)
