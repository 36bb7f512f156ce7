"""The port's ``Checkpointer`` (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint.ckpt``).

The on-disk format is shared: a model tree, a plan, a streamed plan, a
``PlanBatch`` and a ``SessionStore`` written by either package restore in
the other. Integer arrays (permutations, ``col_idx``, ``nbr_mask``,
``alive``, Morton codes) and the stored tiles cross exactly; ``matvec`` is
held within the quickstart's 1e-4 x scale of the reference's. A port round
trip is bit-exact (``torch.equal``). Mirrors the checkpoint cases of
``tests/test_ckpt_ft_pipeline.py`` and the ``save_plan``/``restore_plan``
cases of ``test_plan_lifecycle.py``, ``test_plan_batch.py``,
``test_streaming.py`` and ``test_serve.py``, error paths included.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tn, tt

from repro import api as ref_api
from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro.data.pipeline import feature_mixture
from repro.serve.session import Session as RefSession
from repro.serve.session import SessionStore as RefSessionStore
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.serve.session import Session, SessionStore

N, D, K = 256, 16, 8
CPU = "cpu"


def _scale_close(got, want):
    """Within 1e-4 x max|want| (the quickstart's bound, scaled)."""
    got, want = tn(got), tn(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.fixture(scope="module")
def points():
    return feature_mixture(N, D, n_clusters=8, seed=0)


@pytest.fixture(scope="module")
def port_plan(points):
    p = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                         device=CPU)
    _ = p.gamma
    return p


@pytest.fixture(scope="module")
def ref_plan(points):
    p = ref_api.build_plan(jnp.asarray(points), k=K, bs=16, sb=4,
                           backend="bsr")
    _ = p.gamma
    return p


def _ref_streamed(points):
    rp = ref_api.build_plan(jnp.asarray(points), k=K, bs=16, sb=4,
                            backend="bsr", ell_slack=8)
    kill = np.random.default_rng(10).choice(N, 20, replace=False)
    rp, _ = rp.delete(kill).insert(feature_mixture(8, D, n_clusters=8,
                                                   seed=11))
    return rp


def _port_streamed(points):
    p = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                         ell_slack=8, device=CPU)
    kill = np.random.default_rng(10).choice(N, 20, replace=False)
    p, _ = p.delete(kill).insert(feature_mixture(8, D, n_clusters=8,
                                                 seed=11))
    return p


def _charges(n, seed=15, f=None):
    shape = (n,) if f is None else (n, f)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_plan_state(port, ref):
    """Integer arrays and tiles exact between a port and a reference plan."""
    h, rh = port.host, ref.host
    np.testing.assert_array_equal(h.pi, np.asarray(rh.pi))
    np.testing.assert_array_equal(h.inv, np.asarray(rh.inv))
    np.testing.assert_array_equal(tn(port.bsr.col_idx),
                                  np.asarray(ref.bsr.col_idx))
    np.testing.assert_array_equal(tn(port.bsr.nbr_mask),
                                  np.asarray(ref.bsr.nbr_mask))
    np.testing.assert_array_equal(tn(port.bsr.vals), np.asarray(ref.bsr.vals))
    np.testing.assert_array_equal(port.alive, np.asarray(ref.alive))
    for key in ("codes", "code_lo", "code_hi", "x"):
        a, b = getattr(h, key), getattr(rh, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
    for i, (a, b) in enumerate(zip(h.coo, rh.coo)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"coo {i}")
    assert port.n == ref.n and port.n_alive == ref.n_alive
    assert dataclasses.asdict(port.refresh_stats) == \
        dataclasses.asdict(ref.refresh_stats)


# -- model trees --------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "layers": [torch.full((2,), 3.0), None, torch.zeros(1)]}


def test_ckpt_roundtrip_async(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(3, t)
    ck.wait()
    restored, step = ck.restore(t, device=CPU)
    assert step == 3 and restored["layers"][1] is None
    flat = [t["a"], t["b"]["c"], t["b"]["step"], t["layers"][0],
            t["layers"][2]]
    got = [restored["a"], restored["b"]["c"], restored["b"]["step"],
           restored["layers"][0], restored["layers"][2]]
    for a, b in zip(flat, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ckpt_save_gathers_before_returning(tmp_path):
    """An in-place write after ``save`` returns does not reach the
    checkpoint (the port's storage primitives write in place)."""
    ck = Checkpointer(tmp_path)
    t = {"w": torch.arange(6.0)}
    ck.save(1, t)
    t["w"].mul_(0.0)
    ck.wait()
    restored, _ = ck.restore(t, device=CPU)
    assert torch.equal(restored["w"], torch.arange(6.0))


def test_ckpt_gc_keeps_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    assert ck.steps() == [3, 4]


def test_ckpt_structure_mismatch_and_shardings_raise(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, _tree(), blocking=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore({"only": torch.zeros(3)}, device=CPU)
    with pytest.raises(NotImplementedError, match="A14"):
        ck.restore(_tree(), shardings={"a": None}, device=CPU)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Checkpointer(tmp_path / "empty").restore(_tree(), device=CPU)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_model_tree_crosses_packages(tmp_path, writer):
    """Leaves in ``jax.tree.flatten``'s order (sorted keys, sequences in
    order, ``None`` no leaf); bf16 stored as float32, cast back."""
    rng = np.random.default_rng(3)
    arrs = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "emb": rng.standard_normal((5, 2)).astype(np.float32)}
    ref_tree = {"z": jnp.asarray(arrs["w"]),
                "a": {"y": jnp.asarray(arrs["b"]).astype(jnp.bfloat16),
                      "x": [jnp.asarray(arrs["emb"]), None]}}
    port_tree = {"z": tt(arrs["w"]),
                 "a": {"y": tt(arrs["b"]).to(torch.bfloat16),
                       "x": [tt(arrs["emb"]), None]}}
    if writer == "reference":
        RefCheckpointer(tmp_path).save(5, ref_tree, blocking=True)
        got, step = Checkpointer(tmp_path).restore(port_tree, device=CPU)
        assert step == 5
        assert got["a"]["y"].dtype == torch.bfloat16
        for a, b in ((got["z"], ref_tree["z"]),
                     (got["a"]["y"].float(), ref_tree["a"]["y"]),
                     (got["a"]["x"][0], ref_tree["a"]["x"][0])):
            np.testing.assert_array_equal(tn(a),
                                          np.asarray(b, np.float32))
    else:
        Checkpointer(tmp_path).save(5, port_tree, blocking=True)
        got, step = RefCheckpointer(tmp_path).restore(ref_tree)
        assert step == 5 and got["a"]["y"].dtype == jnp.bfloat16
        for a, b in ((got["z"], port_tree["z"]),
                     (got["a"]["y"], port_tree["a"]["y"]),
                     (got["a"]["x"][0], port_tree["a"]["x"][0])):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          tn(b.float()))


# -- plans: port round trips ------------------------------------------------------


def test_checkpoint_plan_round_trip(tmp_path, port_plan):
    ck = Checkpointer(tmp_path)
    ck.save_plan(7, port_plan, blocking=True)
    assert ck.plan_steps() == [7] and ck.steps() == []
    p2, step = ck.restore_plan(device=CPU)
    assert step == 7
    for f in (None, 3):
        xq = _charges(N, f=f)
        assert torch.equal(p2.matvec(xq), port_plan.matvec(xq))
    for a, b in ((p2.pi, port_plan.pi), (p2.inv, port_plan.inv),
                 (p2.bsr.col_idx, port_plan.bsr.col_idx),
                 (p2.bsr.nbr_mask, port_plan.bsr.nbr_mask),
                 (p2.bsr.vals, port_plan.bsr.vals)):
        assert torch.equal(a, b)
    assert p2.config == port_plan.config
    assert p2.host.gamma == port_plan.host.gamma
    assert p2.bsr.fill == port_plan.bsr.fill
    assert p2.tree.n_levels == port_plan.tree.n_levels
    np.testing.assert_array_equal(p2.tree.perm, port_plan.tree.perm)
    assert dataclasses.asdict(p2.refresh_stats) == \
        dataclasses.asdict(port_plan.refresh_stats)


def test_checkpoint_restore_refreshes_on_drift(tmp_path, port_plan, points):
    ck = Checkpointer(tmp_path)
    ck.save_plan(0, port_plan, blocking=True)
    same, _ = ck.restore_plan(refresh_with=points, device=CPU)
    assert same.refresh_stats.last_migrated_frac == 0.0
    assert same.refresh_stats.last_action == "patch"
    moved = np.random.default_rng(16).permutation(points).copy()
    drift, _ = ck.restore_plan(refresh_with=moved, device=CPU)
    assert drift.refresh_stats.last_action == "rebuild"


def test_checkpoint_plans_and_models_gc_independently(tmp_path, port_plan):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"w": torch.arange(4.0)}
    for s in (10, 20):
        ck.save(s, tree, blocking=True)
    for s in (30, 40, 50):
        ck.save_plan(s, port_plan, blocking=True)
    assert ck.steps() == [10, 20] and ck.plan_steps() == [40, 50]
    restored, step = ck.restore(tree, device=CPU)
    assert step == 20 and torch.equal(restored["w"], tree["w"])
    assert ck.restore_plan(device=CPU)[1] == 50


def test_checkpoint_async_save_plan_gathers_before_returning(tmp_path,
                                                             points):
    """``save_plan`` returns with the tiles on the host: a ``patch_bsr``-
    style in-place write afterwards does not reach the saved plan."""
    p = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                         device=CPU)
    want = p.bsr.vals.clone()
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, p)                       # async
    p.bsr.vals.mul_(2.0)
    ck.wait()
    p2, _ = ck.restore_plan(step=1, device=CPU)
    assert torch.equal(p2.bsr.vals, want)


def test_checkpoint_streamed_plan_round_trip(tmp_path, points):
    p3 = _port_streamed(points)
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, p3, blocking=True)
    r, _ = ck.restore_plan(device=CPU)
    assert r.capacity == p3.capacity and r.n_alive == p3.n_alive
    np.testing.assert_array_equal(r.alive, p3.alive)
    np.testing.assert_array_equal(r.host.codes, p3.host.codes)
    np.testing.assert_array_equal(r.host.x, p3.host.x)
    xv = _charges(p3.n)
    assert torch.equal(r.matvec(xv), p3.matvec(xv))
    r2 = r.delete(np.nonzero(r.alive)[0][:5])       # keeps streaming
    assert r2.n_alive == p3.n_alive - 5


def test_cuda_backend_is_saved_as_pallas_and_restored_as_cuda(tmp_path,
                                                              points):
    p = t_api.build_plan(points, k=K, bs=16, sb=4, backend="cuda",
                         device=CPU)
    ck = Checkpointer(tmp_path)
    ck.save_plan(2, p, blocking=True)
    m = json.loads((tmp_path / "step_2" / "plan_plan" / "manifest.json")
                   .read_text())
    assert m["config"]["backend"] == "pallas"
    assert ck.restore_plan(device=CPU)[0].config.backend == "cuda"
    assert RefCheckpointer(tmp_path).restore_plan()[0].config.backend \
        == "pallas"
    m["config"]["backend"] = "dist"      # the same name in both packages
    (tmp_path / "step_2" / "plan_plan" / "manifest.json").write_text(
        json.dumps(m))
    assert ck.restore_plan(device=CPU)[0].config.backend == "dist"


# -- plans across packages ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["plan", "streamed"])
def test_reference_plan_restores_in_the_port(tmp_path, points, ref_plan,
                                             kind):
    rp = ref_plan if kind == "plan" else _ref_streamed(points)
    RefCheckpointer(tmp_path).save_plan(3, rp, blocking=True)
    p, step = Checkpointer(tmp_path).restore_plan(device=CPU)
    assert step == 3
    _same_plan_state(p, rp)
    for f in (None, 4):
        xq = _charges(rp.n, f=f)
        _scale_close(p.matvec(xq, backend="bsr"), rp.matvec(jnp.asarray(xq)))
    if kind == "plan":
        assert p.host.gamma == rp.host.gamma
        assert p.tree.n_levels == rp.tree.n_levels
    else:                                     # goes on streaming
        assert p.delete(np.nonzero(p.alive)[0][:3]).n_alive == rp.n_alive - 3


@pytest.mark.parametrize("kind", ["plan", "streamed"])
def test_port_plan_restores_in_the_reference(tmp_path, points, port_plan,
                                             kind):
    p = port_plan if kind == "plan" else _port_streamed(points)
    Checkpointer(tmp_path).save_plan(4, p, blocking=True)
    rp, step = RefCheckpointer(tmp_path).restore_plan()
    assert step == 4
    _same_plan_state(p, rp)
    xq = _charges(p.n)
    _scale_close(rp.matvec(jnp.asarray(xq)), p.matvec(xq))
    assert rp.config.backend == "bsr"


# -- batches -------------------------------------------------------------------------


def _members(seed=60):
    return [feature_mixture(96, D, n_clusters=4, seed=seed + i, spread=1.0)
            for i in range(3)]


def test_batch_checkpoint_round_trip(tmp_path):
    pb = t_api.build_plan_batch(_members(), k=5, bs=16, sb=2, backend="bsr",
                                device=CPU)
    xs = _charges(3 * pb.capacity).reshape(3, pb.capacity)
    ck = Checkpointer(tmp_path)
    ck.save_plan(3, pb, name="heads", blocking=True)
    m = json.loads((tmp_path / "step_3" / "plan_heads" / "manifest.json")
                   .read_text())
    assert m["tuned"] == {} and m["batch"] == 3
    pb2, step = ck.restore_plan(name="heads", device=CPU)
    assert step == 3 and pb2.spec == pb.spec
    for a, b in ((pb2.data.col_idx, pb.data.col_idx),
                 (pb2.data.nbr_mask, pb.data.nbr_mask),
                 (pb2.data.vals, pb.data.vals), (pb2.data.pi, pb.data.pi)):
        assert torch.equal(a, b)
    assert torch.equal(pb2.matvec(xs), pb.matvec(xs))
    with pytest.raises(ValueError, match="PlanBatch"):
        ck.restore_plan(name="heads", refresh_with=np.zeros((96, D)),
                        device=CPU)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_batch_crosses_packages(tmp_path, writer):
    members = _members()
    rb = ref_api.build_plan_batch(members, k=5, bs=16, sb=2, backend="bsr")
    xs = _charges(3 * rb.capacity).reshape(3, rb.capacity)
    if writer == "reference":
        rb.tuned = {1: "pallas"}          # written by the reference, ignored
        RefCheckpointer(tmp_path).save_plan(1, rb, name="b", blocking=True)
        pb, _ = Checkpointer(tmp_path).restore_plan(name="b", device=CPU)
        assert not hasattr(pb, "tuned")
        ref = rb
    else:
        pb = t_api.PlanBatch.from_plans(
            [t_convert.plan_from_reference_arrays(
                dataclasses.asdict(m.config), m.n, np.asarray(m.host.pi),
                np.asarray(m.host.inv), tuple(np.asarray(a)
                                              for a in m.host.coo),
                np.asarray(m.bsr.col_idx), np.asarray(m.bsr.nbr_mask),
                np.asarray(m.bsr.vals), m.host.sigma, fill=m.bsr.fill,
                embedding=m.host.embedding, embed_mean=m.host.embed_mean,
                embed_axes=m.host.embed_axes,
                tree_levels=m.host.tree.levels, device=CPU)
             for m in rb.members()])
        Checkpointer(tmp_path).save_plan(1, pb, name="b", blocking=True)
        ref, _ = RefCheckpointer(tmp_path).restore_plan(name="b")
    assert pb.batch == ref.batch and pb.capacity == ref.capacity
    for i in range(3):
        _same_plan_state(pb.member(i), ref.member(i))
    _scale_close(pb.matvec(xs, backend="bsr"), ref.matvec(jnp.asarray(xs)))


# -- session stores ---------------------------------------------------------------------


def _aux(rng, dtype):
    ks = rng.standard_normal((2, 2, 32, 8)).astype(np.float32)
    return {"ks": ks if dtype == "float32" else
            jnp.asarray(ks).astype(jnp.bfloat16),
            "ps": np.arange(32, dtype=np.int32)[None, None].repeat(2, 0),
            "output": np.asarray([5, 7, 9], np.int32),
            "pend_pos": np.asarray(12, np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_session_store_crosses_packages(tmp_path, dtype, writer):
    """Sessions (one profile-only ordering batch per layer), their aux
    payload and the service counters. A reference bf16 aux array (``|V2``
    in the npz) is read as ``torch.bfloat16`` with its bits; the port
    writes bf16 as float32."""
    rng = np.random.default_rng(20)
    rstore = RefSessionStore()
    for rid in (0, 3):
        plans = [ref_api.build_plan_batch(
            [feature_mixture(32, D, n_clusters=4, seed=100 * rid + 10 * l + h)
             for h in range(2)], k=4, bs=8, sb=2, with_bsr=False)
            for l in range(2)]
        rstore.admit(RefSession(rid=rid, slot=rid % 2, blen=32, plans=plans,
                                aux=_aux(rng, dtype)))
    rstore.counters["inserts"] = 11
    if writer == "reference":
        RefCheckpointer(tmp_path).save_plan(4, rstore, name="sessions",
                                            blocking=True)
        store, step = Checkpointer(tmp_path).restore_plan(name="sessions",
                                                          device=CPU)
        ref = rstore
    else:
        store = SessionStore()
        for rid, rs in rstore.sessions.items():
            plans = [t_api.PlanBatch.from_plans(
                [t_convert.plan_from_reference_arrays(
                    dataclasses.asdict(m.config), m.n, np.asarray(m.host.pi),
                    np.asarray(m.host.inv),
                    tuple(np.asarray(a) for a in m.host.coo), None, None,
                    None, m.host.sigma, embedding=m.host.embedding,
                    embed_mean=m.host.embed_mean,
                    embed_axes=m.host.embed_axes,
                    tree_levels=m.host.tree.levels, device=CPU)
                 for m in pb.members()]) for pb in rs.plans]
            aux = {k: (torch.from_numpy(np.asarray(v, np.float32))
                       .to(torch.bfloat16) if k == "ks" and dtype != "float32"
                       else np.asarray(v)) for k, v in rs.aux.items()}
            store.admit(Session(rid=rid, slot=rs.slot, blen=rs.blen,
                                plans=plans, aux=aux))
        store.counters = dict(rstore.counters)
        Checkpointer(tmp_path).save_plan(4, store, name="sessions",
                                         blocking=True)
        ref, step = RefCheckpointer(tmp_path).restore_plan(name="sessions")
    assert step == 4
    assert sorted(store.sessions) == sorted(ref.sessions) == [0, 3]
    assert store.counters == ref.counters
    for rid in (0, 3):
        s, r = store.sessions[rid], ref.sessions[rid]
        assert (s.slot, s.blen, len(s.plans)) == (r.slot, r.blen,
                                                  len(r.plans))
        for pb, rb in zip(s.plans, r.plans):
            assert pb.spec.max_nbr is None and rb.spec.max_nbr is None
            for i in range(pb.batch):
                np.testing.assert_array_equal(pb.hosts[i].pi,
                                              np.asarray(rb.hosts[i].pi))
        for key in ("ps", "output", "pend_pos"):
            np.testing.assert_array_equal(tn(s.aux[key]),
                                          np.asarray(r.aux[key]))
        got, want = s.aux["ks"], r.aux["ks"]
        if writer == "reference" and dtype == "bfloat16":
            assert isinstance(got, torch.Tensor)
            assert got.dtype == torch.bfloat16
        if writer == "port" and dtype == "bfloat16":
            assert np.asarray(want).dtype == np.float32   # widened, lossless
        np.testing.assert_array_equal(
            tn(got.float()) if isinstance(got, torch.Tensor)
            else np.asarray(got, np.float32),
            np.asarray(want, np.float32) if not isinstance(want, torch.Tensor)
            else tn(want.float()))


def test_reference_bf16_array_loads_as_v2_and_crosses_as_bf16(tmp_path):
    a = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32)).astype(
        jnp.bfloat16)
    np.savez(tmp_path / "a.npz", a=np.asarray(a))
    raw = np.load(tmp_path / "a.npz")["a"]
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    got = t_convert.array_from_reference(raw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(tn(got.float()),
                                  np.asarray(a.astype(jnp.float32)))
    same = np.arange(3, dtype=np.int32)
    assert t_convert.array_from_reference(same) is same


# -- restore_plan error paths ------------------------------------------------------------


def test_restore_plan_missing(tmp_path, port_plan):
    ck = Checkpointer(tmp_path)
    with pytest.raises(FileNotFoundError, match="no plan 'plan'"):
        ck.restore_plan(device=CPU)
    ck.save_plan(3, port_plan, blocking=True)
    with pytest.raises(FileNotFoundError, match="no plan 'other'"):
        ck.restore_plan(name="other", device=CPU)
    with pytest.raises(FileNotFoundError, match="step 9"):
        ck.restore_plan(step=9, device=CPU)


def test_restore_plan_corrupt_manifest(tmp_path, port_plan):
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, port_plan, blocking=True)
    (tmp_path / "step_1" / "plan_plan" / "manifest.json").write_text(
        "{not json")
    with pytest.raises(ValueError, match="corrupt plan manifest"):
        ck.restore_plan(device=CPU)


def test_restore_plan_array_shape_mismatch(tmp_path, port_plan):
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, port_plan, blocking=True)
    pd = tmp_path / "step_1" / "plan_plan"
    arrays = dict(np.load(pd / "arrays.npz"))
    trunc = dict(arrays, pi=arrays["pi"][:-5])
    np.savez(pd / "arrays.npz", **trunc)
    with pytest.raises(ValueError, match="pi.*capacity"):
        ck.restore_plan(device=CPU)
    np.savez(pd / "arrays.npz",
             **{k: v for k, v in arrays.items() if k != "bsr_vals"})
    with pytest.raises(ValueError, match="missing arrays.*bsr_vals"):
        ck.restore_plan(device=CPU)
    np.savez(pd / "arrays.npz", **dict(arrays,
                                       bsr_vals=arrays["bsr_vals"][:, :-1]))
    with pytest.raises(ValueError, match="bsr_vals shape"):
        ck.restore_plan(device=CPU)
    np.savez(pd / "arrays.npz", **arrays)
    m = json.loads((pd / "manifest.json").read_text())
    m["bsr"]["max_nbr"] += 1
    (pd / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="does not match the manifest"):
        ck.restore_plan(device=CPU)


def test_restore_plan_reshards_on_a_mesh(tmp_path, port_plan):
    """The sharded restore of ROADMAP A11, ported: ``mesh="auto"`` re-shards
    on ``default_mesh`` of the device, ``axis=`` alone restores unsharded
    (as the reference), and the unsharded restore is unchanged. The full
    round trip is ``test_torch_shardplan.py``'s."""
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, port_plan, blocking=True)
    sp, _ = ck.restore_plan(mesh="auto", device=CPU)
    assert sp.spec.n_dev == 1 and sp.mesh.devices_along("data") == [
        torch.device(CPU)]
    p, _ = ck.restore_plan(axis="data", device=CPU)
    assert p.n == port_plan.n and not hasattr(p, "unshard")
    p, _ = ck.restore_plan(device=CPU)            # unsharded still works
    assert p.n == port_plan.n
    x = torch.ones(p.n)
    assert torch.equal(sp.matvec(x), p.matvec(x, backend="bsr"))


def test_restore_defaults_to_the_card(tmp_path, port_plan, monkeypatch):
    """``device=None`` means the card: with none, restore raises rather
    than landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, port_plan, blocking=True)
    ck.save(2, {"w": torch.zeros(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ck.restore_plan()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ck.restore({"w": torch.zeros(2)})
