"""The ported slice as a whole: ``build_plan -> plan.matvec``.

(a) A reference plan's state crosses over as numpy arrays
(``convert.plan_from_reference_arrays``) and the port's ``matvec``/``apply``
must equal the reference's to float32 ``rtol=1e-5`` on every port backend.
(b) The port's own ``build_plan(device="cpu")`` is held to invariants —
its embedding starts from other random draws than the reference's, so the
permutation need not match: matvec equals the dense ``A @ x``, every
backend agrees to 1e-4 (the quickstart bound), γ lands within 2 % of the
reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, tn, tt

from repro import api as ref_api
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.models import sharding as t_sharding

BACKENDS = ("csr", "bsr", "bsr_ml", "cuda")


def _cross_over(rp):
    """Reference plan -> port plan, through numpy arrays only."""
    b, h = rp.bsr, rp.host
    return t_convert.plan_from_reference_arrays(
        dataclasses.asdict(rp.config), rp.n, np.asarray(h.pi),
        np.asarray(h.inv), tuple(np.asarray(a) for a in h.coo),
        None if b is None else np.asarray(b.col_idx),
        None if b is None else np.asarray(b.nbr_mask),
        None if b is None else np.asarray(b.vals),
        h.sigma, fill=0.0 if b is None else b.fill,
        embedding=h.embedding, embed_mean=h.embed_mean,
        embed_axes=h.embed_axes,
        tree_levels=None if h.tree is None else h.tree.levels,
        device="cpu")


@pytest.fixture(scope="module")
def ref_plan():
    x = feature_mixture(300, 16, n_clusters=6, seed=0)
    rng = np.random.default_rng(1)
    return ref_api.build_plan(x, k=6, bs=8, sb=4, backend="bsr",
                              values=lambda r, c, d2: rng.random(len(r)))


@pytest.fixture(scope="module")
def own_plan():
    x = t_api_data(420)
    rng = np.random.default_rng(2)
    plan = t_api.build_plan(x, k=7, bs=16, sb=4, device="cpu",
                            values=lambda r, c, d2: rng.random(len(r)))
    return x, plan


def t_api_data(n, seed=0):
    from repro_torch.data.pipeline import feature_mixture as fm
    return fm(n, 16, n_clusters=6, seed=seed)


# -- (a) state carried across ------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("f", [None, 5])
def test_converted_plan_matvec_equals_reference(ref_plan, backend, f):
    tp = _cross_over(ref_plan)
    shape = (ref_plan.n,) if f is None else (ref_plan.n, f)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = ref_plan.matvec(jnp.asarray(x), backend="bsr")
    got = tp.matvec(tt(x), backend=backend)
    assert tuple(got.shape) == shape
    tol = dict(atol=1e-4) if backend == "csr" else {}   # scatter order
    assert_close(got, want, **tol)
    xs = ref_plan.permute(jnp.asarray(x))
    assert_close(tp.permute(tt(x)), xs, rtol=0, atol=0)
    assert_close(tp.apply(tt(np.asarray(xs)), backend=backend),
                 ref_plan.apply(xs, backend="bsr"), **tol)


def test_converted_plan_carries_state(ref_plan):
    tp = _cross_over(ref_plan)
    assert tp.spec.shape_key == ref_plan.spec.shape_key
    assert tp.fill == ref_plan.fill
    assert tp.tree.n_levels == ref_plan.tree.n_levels
    np.testing.assert_array_equal(tp.embedding, ref_plan.embedding)
    # γ of the same reordered pattern
    assert tp.gamma == pytest.approx(ref_plan.gamma, rel=1e-5)
    # numpy in, numpy out; the pair is the identity
    a = np.arange(ref_plan.n)
    np.testing.assert_array_equal(tp.unpermute(tp.permute(a)), a)
    np.testing.assert_array_equal(tp.permute(a), ref_plan.permute(a))
    st, rst = tp.stats, ref_plan.stats
    for key in ("n", "capacity", "dead_frac", "fill", "kept_tiles",
                "max_nbr"):
        assert st[key] == rst[key], key
    assert st["backend"] == "bsr"
    with pytest.raises(ValueError, match="unknown PlanConfig knobs"):
        t_convert.plan_from_reference_arrays(
            {"kk": 3}, 4, np.arange(4), np.arange(4), None, None, None,
            None, 1.0, device="cpu")
    with pytest.raises(ValueError, match="permutation pair"):
        t_convert.plan_from_reference_arrays(
            {}, 4, np.arange(4), np.zeros(4, int), None, None, None, None,
            1.0, device="cpu")


def test_profile_only_plan_crosses_over():
    x = feature_mixture(200, 12, n_clusters=4, seed=2)
    rp = ref_api.build_plan(x, k=5, ordering="pca_1d", with_bsr=False)
    tp = _cross_over(rp)
    assert tp.bsr is None and tp.fill is None
    assert tp.gamma == pytest.approx(rp.gamma, rel=1e-5)
    v = np.random.default_rng(0).standard_normal(200).astype(np.float32)
    assert_close(tp.matvec(v, backend="csr"),
                 rp.matvec(jnp.asarray(v), backend="csr"), atol=1e-4)


def test_bsr_from_arrays_and_from_bsr(ref_plan):
    b = ref_plan.bsr
    tb = t_convert.bsr_from_arrays(b.bs, b.sb, b.n, np.asarray(b.col_idx),
                                   np.asarray(b.nbr_mask), np.asarray(b.vals),
                                   fill=b.fill, device="cpu")
    np.testing.assert_array_equal(tb.to_dense(), b.to_dense())
    plan = t_api.InteractionPlan.from_bsr(tb)
    rplan = ref_api.InteractionPlan.from_bsr(b)
    x = np.random.default_rng(5).standard_normal(b.n).astype(np.float32)
    assert_close(plan.matvec(x), rplan.matvec(jnp.asarray(x)))
    assert plan.gamma is None
    with pytest.raises(ValueError, match="no COO"):
        plan.coo
    with pytest.raises(ValueError, match="vals"):
        t_convert.bsr_from_arrays(b.bs + 1, b.sb, b.n, np.asarray(b.col_idx),
                                  np.asarray(b.nbr_mask), np.asarray(b.vals),
                                  device="cpu")
    bad = np.asarray(b.col_idx).copy()
    bad[0, 0] = b.n_cb
    with pytest.raises(ValueError, match="column blocks"):
        t_convert.bsr_from_arrays(b.bs, b.sb, b.n, bad,
                                  np.asarray(b.nbr_mask), np.asarray(b.vals),
                                  device="cpu")


# -- (b) the port's own build_plan -------------------------------------------


@pytest.mark.parametrize("f", [None, 3])
def test_build_plan_matvec_equals_dense(own_plan, f):
    x, plan = own_plan
    n = plan.n
    r, c, v = plan.coo
    dense = np.zeros((n, n), np.float64)
    np.add.at(dense, (plan.host.pi[r], plan.host.pi[c]), v)   # original order
    shape = (n,) if f is None else (n, f)
    ch = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = dense @ ch
    results = {b: tn(plan.matvec(ch, backend=b)) for b in BACKENDS}
    for b, got in results.items():
        assert got.shape == shape
        np.testing.assert_allclose(got, want, atol=TOL["backend"],
                                   err_msg=b)
        np.testing.assert_allclose(got, results["csr"],
                                   atol=TOL["backend"], err_msg=b)
    np.testing.assert_allclose(tn(plan.matvec(ch)), want,
                               atol=TOL["backend"])         # "auto"


def test_build_plan_artifacts(own_plan):
    x, plan = own_plan
    n = plan.n
    assert plan.device.type == "cpu"
    # auto on a CPU plan: the uncalibrated cost model's winner among the
    # plain paths (cuda would run its plain version there and is not
    # ranked); at this shape one launch over few true edges is csr
    assert plan.resolve_backend() == "csr"
    assert plan.resolve_backend("csr") == "csr"
    assert sorted(plan.host.pi.tolist()) == list(range(n))
    a = torch.arange(n)
    assert torch.equal(plan.unpermute(plan.permute(a)), a)
    assert torch.equal(plan.permute(plan.unpermute(a)), a)
    assert plan.tree.n_levels > 1 and plan.embedding.shape == (n, 3)
    assert plan.capacity == plan.n_alive == n and plan.dead_frac == 0.0
    assert plan.alive.all()
    assert 0 < plan.fill <= 1
    assert set(plan.host.timings) == {"knn", "embedding", "tree",
                                      "build_bsr"}
    spec, data = plan.spec, plan.data
    assert hash(spec) == hash(plan.spec)
    view = t_api.InteractionPlan.from_spec_data(spec, data, fill=plan.fill)
    v = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    assert torch.equal(view.matvec(v, backend="bsr"),
                       plan.matvec(v, backend="bsr"))
    assert "InteractionPlan(n=420" in repr(plan) and "cpu" in repr(plan)
    assert plan.stats["kept_tiles"] == int(plan.bsr.nbr_mask.sum())
    doubled = plan.with_values(2.0 * plan.coo[2])
    assert doubled.bsr.max_nbr == plan.bsr.max_nbr
    assert_close(doubled.matvec(v, backend="bsr"),
                 2.0 * plan.matvec(v, backend="bsr"))


@pytest.mark.parametrize("ordering", t_api.ORDERINGS)
def test_gamma_within_two_percent_of_reference(ordering):
    """Same data, each package's own pipeline end to end: the embeddings
    start from different random draws, so permutations may differ, but the
    locality they reach must not."""
    x = feature_mixture(512, 16, n_clusters=8, seed=4)
    rp = ref_api.build_plan(x, k=8, ordering=ordering, with_bsr=False)
    tp = t_api.build_plan(x, k=8, ordering=ordering, with_bsr=False,
                          device="cpu")
    assert tp.gamma == pytest.approx(rp.gamma, rel=0.02)


def test_dual_tree_gamma_beats_scattered():
    x = t_api_data(512, seed=7)
    g = {o: t_api.build_plan(x, k=8, ordering=o, with_bsr=False,
                             device="cpu").gamma
         for o in ("scattered", "dual_tree")}
    assert g["dual_tree"] > 3 * g["scattered"]


def test_build_plan_options():
    x = t_api_data(200, seed=8)
    sym = t_api.build_plan(x, k=5, bs=8, sb=2, symmetrize=True, device="cpu")
    rsym = ref_api.build_plan(x, k=5, bs=8, sb=2, symmetrize=True)
    assert len(sym.coo[0]) == len(rsym.coo[0])
    d = sym.bsr.to_dense()[np.ix_(sym.host.inv, sym.host.inv)]
    assert ((d != 0) == (d.T != 0)).all()
    src = t_api_data(200, seed=9)
    fixed = t_api.build_plan(x, k=4, bs=8, sb=2, sources=src, device="cpu")
    assert fixed.host.sources is src or np.array_equal(fixed.host.sources,
                                                       src)
    arr = np.random.default_rng(0).random(200 * 5).astype(np.float32)
    stat = t_api.build_plan(x, k=5, bs=8, sb=2, values=arr, device="cpu")
    assert stat.host.values_mode == "static"
    cfg = t_api.PlanConfig(k=5, bs=8, sb=2, ell_slack=2)
    viacfg = t_api.build_plan(x, config=cfg, device="cpu")
    plain = t_api.build_plan(x, k=5, bs=8, sb=2, device="cpu")
    assert viacfg.bsr.max_nbr == plain.bsr.max_nbr + 2
    over = t_api.build_plan(x, config=cfg, ell_slack=0, device="cpu")
    assert over.bsr.max_nbr == plain.bsr.max_nbr
    pi = t_api.cluster_order(x, device="cpu")
    np.testing.assert_array_equal(pi, plain.host.pi)
    assert sorted(t_api.cluster_order(x, ordering="lex2",
                                      device="cpu").tolist()) == \
        list(range(200))
    with pytest.raises(ValueError, match="rcm needs"):
        t_api.cluster_order(x, ordering="rcm", device="cpu")


def test_from_coo_identity_and_given_pi():
    n = 64
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, n, 300), rng.integers(0, n, 300)
    vals = rng.random(300).astype(np.float32)
    pi = rng.permutation(n)
    x = rng.standard_normal(n).astype(np.float32)
    for kw in ({}, {"pi": pi}):
        tp = t_api.InteractionPlan.from_coo(rows, cols, vals, n, bs=8, sb=2,
                                            device="cpu", **kw)
        rp = ref_api.InteractionPlan.from_coo(rows, cols, vals, n, bs=8,
                                              sb=2, **kw)
        assert_close(tp.matvec(x, backend="bsr"),
                     rp.matvec(jnp.asarray(x), backend="bsr"))
        np.testing.assert_array_equal(tp.coo[0], rp.coo[0])


# -- errors ------------------------------------------------------------------


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_errors_match_the_reference():
    x = t_api_data(120, seed=1)
    v = np.ones(120, np.float32)
    tp = t_api.build_plan(x, k=4, with_bsr=False, device="cpu")
    rp = ref_api.build_plan(x, k=4, with_bsr=False)
    assert _error(lambda: tp.matvec(v, backend="bsr")) == \
        _error(lambda: rp.matvec(jnp.asarray(v), backend="bsr"))
    assert _error(lambda: tp.with_values(v)) == \
        _error(lambda: rp.with_values(v))
    assert tuple(tp.matvec(v, backend="csr").shape) == (120,)
    assert _error(lambda: t_api.build_plan(x, k=4, values=v[:7],
                                           device="cpu")) == \
        _error(lambda: ref_api.build_plan(x, k=4, values=v[:7]))
    assert _error(lambda: t_api.build_plan(x, k=4, sources=x[:50],
                                           device="cpu")) == \
        _error(lambda: ref_api.build_plan(x, k=4, sources=x[:50]))
    assert _error(lambda: t_api.build_plan(x, k=4, sources=x,
                                           symmetrize=True,
                                           device="cpu")) == \
        _error(lambda: ref_api.build_plan(x, k=4, sources=x,
                                          symmetrize=True))
    assert _error(lambda: t_api.build_plan(x, k=4, capacity=10,
                                           device="cpu")) == \
        _error(lambda: ref_api.build_plan(x, k=4, capacity=10))
    full = t_api.build_plan(x, k=4, bs=8, sb=2, device="cpu")
    with pytest.raises(ValueError, match="did you mean 'cuda'"):
        full.matvec(v, backend="cuda_")


@pytest.mark.parametrize("kw", [
    {"ell_slack": -1}, {"patch_frac": 1.5}, {"drift_tol": -0.1},
    {"gamma_tol": "x"}, {"patch_frac": 0.5, "rebuild_frac": 0.2},
    {"max_dead_frac": 0.0}, {"grow_frac": 0.0}, {"cg_tol": 0},
    {"cg_maxiter": 0}, {"cg_maxiter": 2.5},
])
def test_plan_config_validation_matches_reference(kw):
    assert _error(lambda: t_api.PlanConfig(**kw)) == \
        _error(lambda: ref_api.PlanConfig(**kw))


def test_plan_config_fields_and_preconditioner_names():
    tf = [(f.name, f.default) for f in dataclasses.fields(t_api.PlanConfig)]
    rf = [(f.name, f.default) for f in dataclasses.fields(ref_api.PlanConfig)]
    assert tf == rf
    with pytest.raises(ValueError, match="unknown preconditioner 'ilu'"):
        t_api.PlanConfig(precond="ilu")
    for name in ("block_jacobi", "jacobi", "identity"):
        assert t_api.PlanConfig(precond=name).precond == name
    assert hash(t_api.PlanConfig()) == hash(t_api.PlanConfig())


@pytest.mark.parametrize("call,item", [
    (lambda p: t_sharding.shardings_for({}, {}, p.shard().mesh), "A14"),
])
def test_not_yet_ported_entry_points_raise(own_plan, call, item):
    """What the port still lacks raises with its ROADMAP item; sharding a
    plan itself works (ROADMAP A11, tests/test_torch_shardplan.py), and
    placing parameters over its mesh waits for training (A14)."""
    _, plan = own_plan
    with pytest.raises(NotImplementedError, match=item):
        call(plan)


@pytest.mark.parametrize("call,check", [
    (lambda p: p.insert(None), lambda p, out: out == (p, None)),
    (lambda p: p.delete([0]), lambda p, out: out.n_alive == p.n - 1),
    (lambda p: p.update(insert=None), lambda p, out: out is p),
    (lambda p: p.compact(), lambda p, out: out.refresh_stats.compactions == 1),
    (lambda p: t_api.build_plan_batch(
        [p.host.x, p.host.x[:-8]], k=4, device="cpu"),
     lambda p, out: out.capacity == 512 and
     out.n_alive.tolist() == [p.n, p.n - 8]),
    (lambda p: t_api.build_plan_batch([p.host.x], k=4, capacity=p.n + 8,
                                      device="cpu"),
     lambda p, out: out.capacity == p.n + 8),
    (lambda p: t_api.update_plan(p), lambda p, out: out is p),
    (lambda p: t_api.build_plan(p.host.x, k=4, capacity=p.n + 8,
                                device="cpu"),
     lambda p, out: out.capacity == p.n + 8 and out.n_alive == p.n),
])
def test_streaming_entry_points_are_ported(own_plan, call, check):
    """The streaming entry points that raised before the port's fourth
    slice now run on the CPU."""
    _, plan = own_plan
    assert check(plan, call(plan))


def test_device_none_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    x = t_api_data(64)
    e = np.empty(0, np.int64)
    from repro_torch.core import (blocksparse, embedding, hierarchy, knn,
                                  measures)
    calls = [
        lambda: t_api.build_plan(x, k=4),
        lambda: t_api.cluster_order(x),
        lambda: t_api.InteractionPlan.from_coo(e, e, None, 8),
        lambda: knn.knn_graph(x, x, 3),
        lambda: blocksparse.build_bsr(e, e, None, 8),
        lambda: blocksparse.random_bsr(0, 64, 8, 2),
        lambda: embedding.pca_axes(x, 2),
        lambda: hierarchy.morton_codes(x[:, :2]),
        lambda: measures.gamma_exact(e, e, 2.0),
        lambda: measures.gamma_score(e, e, 2.0, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
