"""Sharded plans (``core/shardplan.py``, ``launch/mesh.py``), port against
reference, on the CPU.

The host analysis is exact: ``ShardSpec`` field by field, the hot set,
the per-device support, ``_local_cols`` and ``_hot_routing`` equal the
reference's on the same BSR arrays at every device count. The sharded
products are held against single-device results — the port's and the
reference's ``apply(x, backend="bsr")`` — at float32 ``rtol 1e-5``, in
every exchange mode, and never against the reference's own sharded paths,
which are red on this JAX (ROADMAP C2). Meshes repeat the one CPU device
(``[cpu] * n``, ROADMAP C32), the port's stand-in for the reference's
forced host devices. The plan is the reference tests' own:
``feature_mixture(512, 32, 8 clusters, seed 0)``, k 8, bs 16, sb 4,
``ell_slack`` 8.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt
from _torch_parity import stream_plan_from_reference as cross_over

from repro import api as ref_api
from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro.core import blocksparse as ref_bs
from repro.core import shardplan as ref_sp
from repro.data.pipeline import feature_mixture
from repro.solvers import RBFValues as RefRBF
from repro.solvers import krr_fit as ref_krr_fit
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import blocksparse as t_bs
from repro_torch.core import shardplan as t_sp
from repro_torch.core.doublebuf import DoubleBufferedPlan
from repro_torch.kernels import bsr_spmv as t_bsr
from repro_torch.launch import mesh as t_mesh
from repro_torch.solvers import RBFValues, krr_fit, solve

N, D, K = 512, 32, 8
CPU = torch.device("cpu")
N_DEVS = [1, 2, 4, 8]


def cpu_mesh(n_dev, axis="data"):
    return t_mesh.make_mesh((n_dev,), (axis,), [CPU] * n_dev)


def port_bsr(rb):
    """A reference BSR -> the port's, through its numpy arrays."""
    return t_convert.bsr_from_arrays(
        rb.bs, rb.sb, rb.n, np.asarray(rb.col_idx), np.asarray(rb.nbr_mask),
        np.asarray(rb.vals), fill=rb.fill, device="cpu")


@pytest.fixture(scope="module")
def clustered():
    return feature_mixture(N, D, n_clusters=8, seed=0)


@pytest.fixture(scope="module")
def plans(clustered):
    rp = ref_api.build_plan(clustered, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8)
    return rp, cross_over(rp)


@pytest.fixture(scope="module")
def hot_plans(clustered):
    """The port's own build of the same points, whose 8-way split carries
    a hot set (its ordering differs from the reference's, ROADMAP C4),
    and the reference plan over the same BSR arrays."""
    tp = t_api.build_plan(clustered, k=K, bs=16, sb=4, backend="bsr",
                          ell_slack=8, device="cpu")
    b = tp.bsr
    rb = ref_bs.BSR(bs=b.bs, sb=b.sb, n=b.n, n_rb=b.n_rb, n_cb=b.n_cb,
                    col_idx=jnp.asarray(tn(b.col_idx)),
                    nbr_mask=jnp.asarray(tn(b.nbr_mask)),
                    vals=jnp.asarray(tn(b.vals)), fill=b.fill,
                    max_nbr=b.max_nbr)
    return ref_api.InteractionPlan.from_bsr(rb), tp


def _charges(seed, n=N):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# -- the mesh ------------------------------------------------------------------


def test_mesh_shape_equality_and_repeated_devices():
    m = t_mesh.make_mesh((4, 2), ("data", "model"), [CPU] * 8)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.devices_along("data") == [CPU] * 4
    assert m == t_mesh.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    assert m != t_mesh.make_mesh((4, 2), ("x", "model"), [CPU] * 8)
    assert hash(m) == hash(t_mesh.make_mesh((4, 2), ("data", "model"),
                                            [CPU] * 8))
    with pytest.raises(ValueError, match="needs 8 devices"):
        t_mesh.make_mesh((4, 2), ("data", "model"), [CPU] * 4)


def test_default_mesh_is_every_card_or_the_cpu():
    m = t_mesh.default_mesh("data", device="cpu")
    assert m.shape == {"data": 1} and m.devices_along("data") == [CPU]
    assert t_mesh.default_mesh("data", device="cpu") is m       # memoized
    if torch.cuda.is_available():
        got = t_mesh.default_mesh("data")
        assert got.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mesh.default_mesh("data")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mesh.make_mesh((2,), ("data",))


# -- host analysis: exact ----------------------------------------------------


@pytest.mark.parametrize("n_dev", N_DEVS + [3])
def test_shard_spec_hot_and_routes_equal_the_reference(plans, n_dev):
    rp, tp = plans
    want, whot = ref_sp.analyze_shards(rp.bsr, n_dev)
    got, ghot = t_sp.analyze_shards(tp.bsr, n_dev)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.transfer_blocks, got.allgather_blocks) == (
        want.transfer_blocks, want.allgather_blocks)
    np.testing.assert_array_equal(ghot, whot)
    for a, b in zip(t_sp._support(tp.bsr, got.rb_per, n_dev),
                    ref_sp._support(rp.bsr, want.rb_per, n_dev)):
        np.testing.assert_array_equal(a, b)
    col, mask = np.asarray(rp.bsr.col_idx), np.asarray(rp.bsr.nbr_mask)
    np.testing.assert_array_equal(t_sp._local_cols(col, mask, got, ghot),
                                  ref_sp._local_cols(col, mask, want, whot))
    for a, b in zip(t_sp._hot_routing(got, ghot),
                    ref_sp._hot_routing(want, whot)):
        np.testing.assert_array_equal(a, b)


def test_hot_set_and_its_routes_equal_the_reference(hot_plans):
    rp, tp = hot_plans
    want, whot = ref_sp.analyze_shards(rp.bsr, 8)
    got, ghot = t_sp.analyze_shards(tp.bsr, 8)
    assert got.mode == "halo" and got.n_hot > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(ghot, whot)
    col, mask = np.asarray(rp.bsr.col_idx), np.asarray(rp.bsr.nbr_mask)
    np.testing.assert_array_equal(t_sp._local_cols(col, mask, got, ghot),
                                  ref_sp._local_cols(col, mask, want, whot))
    for a, b in zip(t_sp._hot_routing(got, ghot),
                    ref_sp._hot_routing(want, whot)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_clustered_plan_halo_beats_allgather(plans, n_dev):
    _, tp = plans
    spec, _ = t_sp.analyze_shards(tp.bsr, n_dev)
    assert spec.mode == "halo"
    assert spec.transfer_blocks < spec.allgather_blocks


@pytest.mark.parametrize("kind,args,n_dev,mode", [
    ("banded", (0, 2048, 32, 4), 2, "halo"),
    ("banded", (0, 2048, 32, 4), 4, "halo"),
    ("banded", (0, 2048, 32, 4), 8, "halo"),
    ("banded", (0, 640, 16, 12), 8, "ring"),
    ("scattered", (3, 2048, 32, 8), 8, "allgather"),
])
def test_the_three_covers_equal_the_reference(kind, args, n_dev, mode):
    rb = ref_bs.random_bsr(*args, banded=kind == "banded")
    tb = t_bs.random_bsr(*args, banded=kind == "banded", device="cpu")
    np.testing.assert_array_equal(tn(tb.col_idx), np.asarray(rb.col_idx))
    want, whot = ref_sp.analyze_shards(rb, n_dev)
    got, ghot = t_sp.analyze_shards(tb, n_dev)
    assert got.mode == mode
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(ghot, whot)
    if kind == "banded" and mode == "halo":
        assert got.halo_lo + got.halo_hi <= args[3]
    if mode == "allgather":
        assert got.transfer_blocks == got.allgather_blocks
    else:
        assert got.transfer_blocks < got.allgather_blocks


# -- shard / unshard / apply ---------------------------------------------------


@pytest.mark.parametrize("n_dev", N_DEVS + [3])
def test_unshard_is_bit_identical(plans, n_dev):
    _, tp = plans
    sp = tp.shard(cpu_mesh(n_dev))
    b, b2 = tp.bsr, sp.unshard()
    for name in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(b2, name), getattr(b, name)), name
    assert (b2.bs, b2.sb, b2.n, b2.n_rb, b2.n_cb, b2.max_nbr) == (
        b.bs, b.sb, b.n, b.n_rb, b.n_cb, b.max_nbr)
    assert len(sp.vals) == n_dev
    assert all(v.shape[0] == sp.spec.rb_per for v in sp.vals)


def _case(plans, hot_plans, case):
    """(reference plan, port plan, mesh, expected mode) of one case."""
    if case == "halo_hot":
        return (*hot_plans, cpu_mesh(8), "halo")
    if case in ("ring", "allgather"):
        args = (0, 640, 16, 12) if case == "ring" else (3, 2048, 32, 8)
        rb = ref_bs.random_bsr(*args, banded=case == "ring")
        rp = ref_api.InteractionPlan.from_bsr(rb)
        return rp, t_api.InteractionPlan.from_bsr(port_bsr(rb)), \
            cpu_mesh(8), case
    rp, tp = plans
    n_dev = {"one": 1, "halo": 4, "nondivisible": 3}[case]
    return rp, tp, cpu_mesh(n_dev), "halo"


@pytest.mark.parametrize("case", ["one", "halo", "halo_hot", "ring",
                                  "allgather", "nondivisible"])
def test_sharded_apply_matches_single_device(plans, hot_plans, case):
    rp, tp, mesh, mode = _case(plans, hot_plans, case)
    sp = tp.shard(mesh)
    assert sp.spec.mode == mode
    if case == "halo_hot":
        assert sp.spec.n_hot > 0
    if case == "nondivisible":
        assert tp.bsr.n_rb % sp.spec.n_dev
    x = _charges(1, tp.n)
    y = sp.apply(tt(x))
    assert y.shape == (tp.n,)
    assert_close(y, tp.apply(tt(x), backend="bsr"))
    assert_close(y, rp.apply(jnp.asarray(x), backend="bsr"))
    assert_close(sp.matvec(x), tp.matvec(tt(x), backend="bsr"))


def test_the_window_reaches_the_kernel_whole(hot_plans, monkeypatch):
    """The local operator is rectangular: each shard hands B2 its whole
    window (``win + n_hot`` column blocks, more than its ``rb_per`` row
    blocks) with its own slot mask."""
    _, tp = hot_plans
    sp = tp.shard(cpu_mesh(8))
    assert sp.spec.n_hot > 0
    seen = []
    real = t_bsr.bsr_spmv

    def spy(vals, col_idx, x, nbr_mask=None, **kw):
        seen.append((vals.shape[0], x.shape, nbr_mask is not None, kw))
        return real(vals, col_idx, x, nbr_mask, **kw)

    monkeypatch.setattr(t_bsr, "bsr_spmv", spy)
    sp.apply(tt(_charges(2)))
    spec, bs = sp.spec, tp.bsr.bs
    assert len(seen) == spec.n_dev                  # one launch per shard
    for rows, xshape, masked, kw in seen:
        assert rows == spec.rb_per and masked
        assert xshape == ((spec.win + spec.n_hot) * bs, 1)
        assert xshape[0] > rows * bs
        assert kw == {"indices_checked": True}


def test_shard_memo_and_dist_backend(plans):
    rp, tp = plans
    x = tt(_charges(3))
    y1 = tp.apply(x, backend="dist")
    sp = tp.host.shard_cache[(1, "data")]
    y2 = tp.apply(x, backend="dist")
    assert tp.host.shard_cache[(1, "data")] is sp
    assert tp.shard() is sp and t_api.shard(tp) is sp
    assert_close(y1, rp.apply(jnp.asarray(tn(x)), backend="bsr"))
    assert torch.equal(y1, y2)
    m4 = cpu_mesh(4)
    sp4 = tp.shard(m4)
    assert tp.shard(cpu_mesh(4)) is sp4           # meshes compare equal
    assert_close(tp.apply(x, backend="dist", mesh=m4), y1)


def test_sharded_rejects_what_the_reference_rejects(plans, clustered):
    _, tp = plans
    sp = tp.shard(cpu_mesh(2))
    with pytest.raises(ValueError, match="1-D"):
        sp.apply(torch.ones((N, 3)))
    with pytest.raises(ValueError, match="charges for a plan"):
        sp.apply(torch.ones(N + 16 * 40))
    with pytest.raises(ValueError, match="1-D"):
        solve(sp, torch.ones((N, 2)), shift=5.0)
    with pytest.raises(ValueError, match="no axis 'model'"):
        tp.shard(cpu_mesh(2), axis="model")
    profile = t_api.build_plan(clustered, k=K, with_bsr=False, device="cpu")
    with pytest.raises(ValueError, match="profile-only"):
        profile.shard(cpu_mesh(2))
    assert "mode='halo'" in repr(sp) and sp.n == N and sp.device == CPU
    assert 0.0 < sp.transfer_fraction < 1.0


def test_shard_rejects_a_mesh_of_another_device_type(plans):
    """``apply`` copies between the shards and the plan's device without a
    sync, which a card-to-host copy would race, so a mesh must hold the
    plan's device type only."""
    _, tp = plans
    for devs in (["meta"] * 2, [CPU, "meta"]):
        mesh = t_mesh.make_mesh((2,), ("data",), devs)
        with pytest.raises(ValueError, match="the plan lives on cpu"):
            tp.shard(mesh)
    assert (2, "data") not in tp.host.shard_cache or \
        tp.host.shard_cache[(2, "data")].mesh == cpu_mesh(2)


# -- solve -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def sym_plans(clustered):
    rp = ref_api.build_plan(clustered, k=K, bs=16, sb=4, backend="bsr",
                            symmetrize=True, values=RefRBF())
    tp = cross_over(rp)
    tp.host.values_fn = RBFValues(rp.host.values_fn.bandwidth)
    return rp, tp


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_solve_matches_the_single_device_solves(sym_plans, n_dev):
    rp, tp = sym_plans
    b = _charges(4)
    sp = tp.shard(cpu_mesh(n_dev))
    res = sp.solve(tt(b), shift=5.0, tol=1e-6, maxiter=400)
    one = tp.solve(tt(b), shift=5.0, tol=1e-6, maxiter=400)
    ref = rp.solve(jnp.asarray(b), shift=5.0, tol=1e-6, maxiter=400)
    assert bool(res.converged)
    assert abs(int(res.iters) - int(ref.iters)) <= 1
    scale = float(np.abs(np.asarray(ref.x)).max())
    assert_close(res.x, ref.x, atol=1e-5 * scale)
    assert_close(res.x, one.x, atol=1e-5 * scale)


def test_sharded_krr_fit_matches_the_reference(sym_plans, clustered):
    rp, tp = sym_plans
    y = np.tanh(clustered @ np.random.default_rng(18).standard_normal(
        D).astype(np.float32)).astype(np.float32)
    model = krr_fit(tp.shard(cpu_mesh(4)), tt(y), lam=0.5, tol=1e-6,
                    maxiter=400)
    ref = ref_krr_fit(rp, jnp.asarray(y), lam=0.5, tol=1e-6, maxiter=400)
    assert model.operator is tp
    assert_close(model.self_weight, ref.self_weight)
    scale = float(np.abs(np.asarray(ref.alpha)).max())
    assert_close(model.alpha, ref.alpha, atol=1e-5 * scale)


# -- lifecycle: in place where the layout holds, re-shard where not ----------


@pytest.fixture(scope="module")
def stream_plans():
    """Wide clusters: streaming parity holds off kNN near-ties (C17)."""
    x = feature_mixture(N, D, n_clusters=8, seed=0, spread=1.0)
    rp = ref_api.build_plan(x, k=K, bs=16, sb=4, backend="bsr", ell_slack=8)
    return rp, cross_over(rp)


def test_sharded_delete_patches_only_the_owning_shards(stream_plans):
    rp, tp = stream_plans
    sp = tp.shard(cpu_mesh(4))
    before = [v.clone() for v in sp.vals]
    x = _charges(5)
    y_before = sp.matvec(tt(x)).clone()
    kill = np.asarray(tp.host.pi[40:52], np.int64)   # one cluster-order run
    sp2 = sp.delete(kill)
    rp2 = rp.update(delete=kill)
    assert sp2.plan.refresh_stats.last_action == "tombstone"
    assert (sp2.shard_patches, sp2.reshards) == (1, 0)
    touched = sp2.plan.host.last_patch_rb
    owners = set((touched // sp.spec.rb_per).tolist())
    for d in range(4):
        assert (sp2.vals[d] is sp.vals[d]) == (d not in owners), d
        assert (sp2.lcol[d] is sp.lcol[d]) == (d not in owners), d
    b2 = sp2.unshard()
    for name in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(b2, name), getattr(sp2.plan.bsr, name))
    np.testing.assert_array_equal(tn(b2.col_idx), np.asarray(rp2.bsr.col_idx))
    assert_close(b2.vals, rp2.bsr.vals)
    assert_close(sp2.matvec(tt(x)), rp2.matvec(jnp.asarray(x), backend="bsr"))
    # ROADMAP C6: the input ShardedPlan is untouched
    for a, b in zip(before, sp.vals):
        assert torch.equal(a, b)
    assert torch.equal(sp.matvec(tt(x)), y_before)


def test_sharded_compact_reshards(stream_plans):
    _, tp = stream_plans
    sp = tp.shard(cpu_mesh(4))
    sp2 = sp.update(policy="compact")
    assert (sp2.reshards, sp2.shard_patches) == (1, 0)
    assert sp2.plan.refresh_stats.last_action == "compact"
    x = tt(_charges(6, sp2.plan.n))
    assert_close(sp2.matvec(x), sp2.plan.matvec(x, backend="bsr"))
    assert sp2.plan.host.shard_cache[(4, "data")] is sp2


def test_sharded_absorb_of_a_double_buffer_swap(stream_plans):
    """The in-place half patches the shards, the swapped-in compaction
    re-shards on the same mesh; each held against the reference's
    single-device ``update_plan`` / ``apply_pending_layout``."""
    rp, tp = stream_plans
    mesh = cpu_mesh(4)
    sp = tp.shard(mesh)
    dbp = DoubleBufferedPlan(tp)
    dbp.update(delete=np.arange(160))     # tombstones now, compacts behind
    rp2 = ref_api.update_plan(rp, delete=np.arange(160), defer_layout=True)
    assert rp2.host.pending_layout == "compact"
    sp = sp.absorb(dbp.plan)               # the in-place half: patches
    assert (sp.shard_patches, sp.reshards) == (1, 0)
    np.testing.assert_array_equal(tn(sp.unshard().col_idx),
                                  np.asarray(rp2.bsr.col_idx))
    dbp.wait()
    assert dbp.generation == 1
    sp2 = sp.absorb(dbp.plan)
    assert (sp2.reshards, sp2.shard_patches) == (1, 1)
    assert sp2.mesh == mesh and sp2.plan is dbp.plan
    swapped = ref_api.apply_pending_layout(rp2)
    x = _charges(7, swapped.n)
    assert sp2.plan.n == swapped.n
    assert_close(sp2.matvec(tt(x)), swapped.matvec(jnp.asarray(x),
                                                   backend="bsr"))


def test_sharded_patch_refresh_matches_the_global_refresh(plans, clustered):
    rp, tp = plans
    rng = np.random.default_rng(7)
    x2 = (clustered + 0.08 * rng.standard_normal(clustered.shape)
          ).astype(np.float32)
    sp = tp.shard(cpu_mesh(4))
    sp2 = sp.refresh(x2, policy="patch")
    assert sp2.plan.refresh_stats.last_action == "patch"
    assert sp2.shard_patches + sp2.reshards == 1
    glob = rp.refresh(jnp.asarray(x2), policy="patch")
    x = _charges(8)
    assert_close(sp2.matvec(tt(x)), glob.matvec(jnp.asarray(x),
                                                backend="bsr"))


# -- persistence -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sharded_restore_equals_the_single_device_round_trip(
        plans, tmp_path, writer):
    rp, tp = plans
    if writer == "port":
        Checkpointer(tmp_path).save_plan(0, tp.shard(cpu_mesh(2),
                                                     axis="data"),
                                         blocking=True)
        m = json.loads((tmp_path / "step_0" / "plan_plan" / "manifest.json")
                       .read_text())
        assert m["shard"] == {"axis": "data", "n_dev": 2, "mode": "halo"}
    else:
        RefCheckpointer(tmp_path).save_plan(0, rp, blocking=True)
    ck = Checkpointer(tmp_path)
    plain, _ = ck.restore_plan(0, device=CPU)
    mesh = cpu_mesh(4, axis="rows")
    sp, step = ck.restore_plan(0, mesh=mesh, device=CPU)
    assert step == 0 and isinstance(sp, t_api.ShardedPlan)
    assert sp.spec.axis == "rows" and sp.spec.n_dev == 4 and sp.mesh == mesh
    x = tt(_charges(9))
    assert torch.equal(sp.matvec(x), plain.shard(mesh, axis="rows").matvec(x))
    assert_close(sp.matvec(x), rp.matvec(jnp.asarray(tn(x)), backend="bsr"))
    auto, _ = ck.restore_plan(0, mesh="auto", device=CPU)
    assert auto.spec.n_dev == 1 and auto.spec.axis == "data"
    with pytest.raises(TypeError, match="Mesh or 'auto'"):
        ck.restore_plan(0, mesh="everywhere", device=CPU)
    with pytest.raises(ValueError, match="no axis 'model'"):
        ck.restore_plan(0, mesh=mesh, axis="model", device=CPU)
