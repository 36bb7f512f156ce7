"""Planner stages of the port (kNN, embedding, hierarchy, orderings,
measures) against the reference, each fed the reference's upstream
artifact so that integer results can be compared exactly.

Tolerances: integer artifacts (neighbor indices on well-separated data,
Morton codes, tree levels, permutations) are exactly equal; float32
results ``rtol=1e-5`` unless a reason is given at the comparison.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt

from repro.core import embedding as ref_emb
from repro.core import hierarchy as ref_h
from repro.core import knn as ref_knn
from repro.core import measures as ref_m
from repro.core import ordering as ref_ord
from repro.data.pipeline import feature_mixture as ref_mixture
from repro_torch.core import embedding as t_emb
from repro_torch.core import hierarchy as t_h
from repro_torch.core import knn as t_knn
from repro_torch.core import measures as t_m
from repro_torch.core import ordering as t_ord
from repro_torch.data import pipeline as t_data


def _points(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# -- data --------------------------------------------------------------------


def test_feature_mixture_identical_from_seed():
    np.testing.assert_array_equal(
        t_data.feature_mixture(300, 16, n_clusters=8, seed=3),
        ref_mixture(300, 16, n_clusters=8, seed=3))
    assert t_data.sift_like(64).shape == (64, 128)
    assert t_data.gist_like(32).shape == (32, 960)


# -- kNN ---------------------------------------------------------------------


def _assert_same_knn(got, want, d2_tol=1e-4):
    gi, gd = tn(got[0]), tn(got[1])
    wi, wd = np.asarray(want[0]), np.asarray(want[1])
    assert gi.shape == wi.shape and gd.shape == wd.shape
    # distances: the -2 q.s expansion cancels, so errors are absolute at
    # the scale of |q|^2 + |s|^2 (~2 D here)
    np.testing.assert_allclose(gd, wd, atol=d2_tol, rtol=1e-5)
    # indices agree wherever the neighbor is separated from the next one
    # by more than the distance error; random data has no closer ties
    differ = gi != wi
    assert not differ.any(), f"{differ.sum()} neighbor indices differ"


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_graph_matches_reference(exclude_self):
    x = _points(0, 300, 12)
    # block=128: the last row block is not full (300 = 2*128 + 44)
    want = ref_knn.knn_graph(jnp.asarray(x), jnp.asarray(x), 7, block=128,
                             exclude_self=exclude_self)
    got = t_knn.knn_graph(x, x, 7, block=128, exclude_self=exclude_self,
                          device="cpu")
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    _assert_same_knn(got, want)
    if exclude_self:
        assert (tn(got[0]) != np.arange(300)[:, None]).all()
    else:
        assert (tn(got[0])[:, 0] == np.arange(300)).all()


def test_knn_graph_exclude_self_gives_no_nan():
    """Regression: masking the diagonal as ``mask * inf`` is NaN off the
    diagonal in PyTorch (0 * inf); the port fills the mask instead."""
    x = _points(1, 70, 5)
    idx, d2 = t_knn.knn_graph(x, x, 69, block=32, exclude_self=True,
                              device="cpu")
    assert torch.isfinite(d2).all()
    assert (d2 >= 0).all()
    # every other point appears exactly once per row
    assert (np.sort(tn(idx), 1) ==
            np.array([np.delete(np.arange(70), i) for i in range(70)])).all()


def test_knn_graph_valid_mask_and_separate_sources():
    t, s = _points(2, 90, 8), _points(3, 140, 8)
    valid = np.random.default_rng(4).random(140) > 0.4
    want = ref_knn.knn_graph(jnp.asarray(t), jnp.asarray(s), 5, block=64,
                             valid=jnp.asarray(valid))
    got = t_knn.knn_graph(t, s, 5, block=64, valid=valid, device="cpu")
    _assert_same_knn(got, want)
    assert valid[tn(got[0])].all()
    rows, cols, d2 = t_knn.knn_coo(t, s, 5, block=64, device="cpu")
    wr, wc, wd = ref_knn.knn_coo(jnp.asarray(t), jnp.asarray(s), 5, block=64)
    np.testing.assert_array_equal(tn(rows), np.asarray(wr))
    np.testing.assert_array_equal(tn(cols), np.asarray(wc))
    np.testing.assert_allclose(tn(d2), np.asarray(wd), atol=1e-4)
    with pytest.raises(ValueError, match="neighbors asked"):
        t_knn.knn_graph(t, s[:4], 5, device="cpu")


# -- embedding ---------------------------------------------------------------


def _ref_init(dim, d):
    """The reference's start of the subspace iteration."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (dim, d),
                                        dtype=jnp.float32))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_pca_axes_shared_init_same_subspace(d):
    x = ref_mixture(400, 16, n_clusters=6, seed=1)
    wa, ws = ref_emb.pca_axes(jnp.asarray(x), d)
    ga, gs = t_emb.pca_axes(x, d, init=_ref_init(16, d), device="cpu")
    wa, ga = np.asarray(wa), tn(ga)
    # singular values in the subspace: float32 sums over 400 rows
    np.testing.assert_allclose(tn(gs), np.asarray(ws), rtol=1e-4)
    # QR signs differ between implementations: compare projectors, and
    # columns up to sign
    np.testing.assert_allclose(ga @ ga.T, wa @ wa.T, atol=2e-4)
    np.testing.assert_allclose(np.abs(np.sum(ga * wa, 0)), 1.0, atol=1e-4)
    np.testing.assert_allclose(ga.T @ ga, np.eye(d), atol=1e-5)
    assert_close(t_emb.explained_ratio(x, gs, device="cpu"),
                 ref_emb.explained_ratio(jnp.asarray(x), ws), rtol=1e-4)


def test_pca_axes_default_init_and_bad_init():
    x = ref_mixture(200, 10, n_clusters=4, seed=2)
    a1, s1 = t_emb.pca_axes(x, 2, device="cpu")
    a2, s2 = t_emb.pca_axes(x, 2, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(s1, s2)     # seeded default
    assert (tn(s1)[:-1] >= tn(s1)[1:]).all()
    with pytest.raises(ValueError, match="init must be"):
        t_emb.pca_axes(x, 2, init=np.zeros((3, 2)), device="cpu")


def test_embed_pca_map_apply_and_det():
    x = ref_mixture(300, 12, n_clusters=5, seed=3)
    xj = jnp.asarray(x)
    init = _ref_init(12, 3)
    wy = np.asarray(ref_emb.embed(xj, 3))
    gy = tn(t_emb.embed(x, 3, init=init, device="cpu"))
    sign = np.sign(np.sum(gy * wy, 0))
    # coordinates of magnitude ~10: absolute float32 error of the products
    np.testing.assert_allclose(gy * sign, wy, atol=2e-3)
    mean, axes = t_emb.pca_map(x, 3, init=init, device="cpu")
    np.testing.assert_allclose(tn(t_emb.apply_pca_map(x, mean, axes,
                                                      device="cpu")),
                               gy, atol=1e-5)
    wm, wax = ref_emb.pca_map(xj, 3)
    # apply_pca_map is a plain affine map: same map in, same image out
    assert_close(t_emb.apply_pca_map(x, np.asarray(wm), np.asarray(wax),
                                     device="cpu"),
                 ref_emb.apply_pca_map(xj, wm, wax), atol=1e-4)
    wd = np.asarray(ref_emb.pca_project_det(xj, 2))
    gd = tn(t_emb.pca_project_det(x, 2, device="cpu"))
    sd = np.sign(np.sum(gd * wd, 0))
    np.testing.assert_allclose(gd * sd, wd, atol=2e-3)


# -- hierarchy ---------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("bits", [0, 6, 10])
def test_morton_codes_exactly_equal(d, bits):
    x = ref_mixture(500, 16, n_clusters=7, seed=d)
    y = np.asarray(ref_emb.embed(jnp.asarray(x), d))     # reference's image
    want = np.asarray(ref_h.morton_codes(jnp.asarray(y), bits))
    got = tn(t_h.morton_codes(y, bits, device="cpu"))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # explicit box, with points clipping at both ends
    lo, hi = y.min(0, keepdims=True) * 0.5, y.max(0, keepdims=True) * 0.5
    want = np.asarray(ref_h.morton_codes_box(jnp.asarray(y), jnp.asarray(lo),
                                             jnp.asarray(hi), bits))
    got = tn(t_h.morton_codes_box(y, lo, hi, bits, device="cpu"))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        tn(t_h.morton_order(y, bits, device="cpu")),
        np.argsort(np.asarray(ref_h.morton_codes(jnp.asarray(y), bits)),
                   kind="stable"))
    assert t_h.eff_bits(d, bits) == ref_h.eff_bits(d, bits)


def test_morton_codes_reject_d4():
    with pytest.raises(ValueError, match="d<=3"):
        t_h.morton_codes(np.zeros((4, 4), np.float32), device="cpu")


@pytest.mark.parametrize("d,leaf", [(2, 16), (3, 8), (3, 64), (1, 4)])
def test_tree_levels_equal(d, leaf):
    x = ref_mixture(600, 16, n_clusters=9, seed=10 + d)
    y = np.asarray(ref_emb.embed(jnp.asarray(x), d))
    want = ref_h.build_tree(y, bits=10, leaf_size=leaf)
    got = t_h.build_tree(y, bits=10, leaf_size=leaf, device="cpu")
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.n_levels == want.n_levels and (got.d, got.bits) == (d, 10)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.clusters(1), want.clusters(1))
    codes = np.asarray(ref_h.morton_codes(jnp.asarray(y), 10))
    again = t_h.tree_from_codes(codes.astype(np.int64), want.perm, d, 10,
                                leaf, max_levels=3)
    ref_again = ref_h.tree_from_codes(codes, want.perm, d, 10, leaf,
                                      max_levels=3)
    assert again.n_levels == ref_again.n_levels
    for a, b in zip(again.levels, ref_again.levels):
        np.testing.assert_array_equal(a, b)


# -- orderings ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ordering_case():
    x = ref_mixture(400, 16, n_clusters=8, seed=5)
    xj = jnp.asarray(x)
    rows, cols, _ = ref_knn.knn_coo(xj, xj, 6, exclude_self=True)
    emb = {d: np.asarray(ref_emb.embed(xj, d)) for d in (1, 2, 3)}
    return x, np.asarray(rows), np.asarray(cols), emb


@pytest.mark.parametrize("name", t_ord.ORDERINGS)
def test_each_ordering_equals_reference(ordering_case, name):
    """Fed the reference's embedding (or pattern), every ordering gives the
    reference's permutation exactly."""
    x, rows, cols, emb = ordering_case
    want = ref_ord.compute_ordering(name, x, rows, cols, seed=3)
    if name == "scattered":
        got = t_ord.scattered(len(x), seed=3)
    elif name == "rcm":
        got = t_ord.rcm(rows, cols, len(x))
    elif name == "pca_1d":
        got = t_ord.pca_1d(x, y=emb[1], device="cpu")
    elif name in ("lex2", "lex3"):
        d = int(name[-1])
        got = t_ord.lex(x, d=d, y=emb[d], device="cpu")
    else:
        got = t_ord.dual_tree(x, d=3, y=emb[3], device="cpu")
        np.testing.assert_array_equal(
            t_ord.dual_tree_fast(x, d=3, y=emb[3], device="cpu"), got)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(x)))


@pytest.mark.parametrize("name", t_ord.ORDERINGS)
def test_compute_ordering_own_embedding_is_a_permutation(ordering_case, name):
    x, rows, cols, _ = ordering_case
    pi = t_ord.compute_ordering(name, x, rows, cols, seed=1, device="cpu")
    assert sorted(np.asarray(pi).tolist()) == list(range(len(x)))


def test_compute_ordering_unknown_and_apply_ordering(ordering_case):
    x, rows, cols, _ = ordering_case
    with pytest.raises(ValueError, match="unknown ordering"):
        t_ord.compute_ordering("zorder", x, rows, cols, device="cpu")
    pi = t_ord.scattered(len(x), 2)
    ps = t_ord.scattered(len(x), 9)
    for args in ((pi,), (pi, ps)):
        g = t_ord.apply_ordering(rows, cols, *args)
        w = ref_ord.apply_ordering(rows, cols, *args)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


# -- measures ----------------------------------------------------------------


def _pattern(seed, nnz, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, nnz), rng.integers(0, n, nnz)


@pytest.mark.parametrize("n,sigma,cells", [(400, 8.0, 0), (1000, 3.0, 0),
                                           (300, 15.0, 24)])
def test_gamma_score_matches_reference(n, sigma, cells):
    rows, cols = _pattern(n, 5 * n, n)
    want = ref_m.gamma_score(jnp.asarray(rows), jnp.asarray(cols), sigma, n,
                             cells=cells)
    got = t_m.gamma_score(rows, cols, sigma, n, cells=cells, device="cpu")
    # same bins, same stencil; the 81 shifted adds sum in another order
    # than the reference's convolution
    assert_close(got, want, rtol=1e-5)


def test_gamma_score_weights_and_empty():
    rows, cols = _pattern(1, 900, 250)
    w = (np.random.default_rng(2).random(900) > 0.25).astype(np.float32)
    want = ref_m.gamma_score(jnp.asarray(rows), jnp.asarray(cols), 6.0, 250,
                             weights=jnp.asarray(w))
    got = t_m.gamma_score(rows, cols, 6.0, 250, weights=w, device="cpu")
    assert_close(got, want)
    keep = w > 0
    assert_close(got, t_m.gamma_score(rows[keep], cols[keep], 6.0, 250,
                                      device="cpu"))
    e = np.empty(0, np.int64)
    assert float(t_m.gamma_score(e, e, 4.0, 10, device="cpu")) == 0.0
    assert float(t_m.gamma_exact(e, e, 4.0, device="cpu")) == 0.0


@pytest.mark.parametrize("nnz", [600, 2048, 2049, 2600])
def test_gamma_exact_both_sides_of_the_threshold(nnz):
    """Up to 2048 nonzeros the dense sum, above it the tiled path (the
    kernel's plain version here) — same routing as the reference."""
    rows, cols = _pattern(nnz, nnz, 500)
    want = ref_m.gamma_exact(jnp.asarray(rows), jnp.asarray(cols), 7.0)
    got = t_m.gamma_exact(rows, cols, 7.0, device="cpu")
    assert_close(got, want)
    forced = t_m.gamma_exact(rows, cols, 7.0, tiled=nnz <= 2048,
                             device="cpu")
    assert_close(forced, want)               # either route, same sum
    assert_close(t_m.gamma_exact(tt(rows), tt(cols), 7.0), want)


def test_beta_fill_compact_live_match_reference():
    rows, cols = _pattern(4, 2000, 300)
    want = ref_m.beta_estimate(rows, cols, 300)
    got = t_m.beta_estimate(rows, cols, 300)
    assert got["block"] == want["block"] and got["beta"] == want["beta"]
    assert got["per_block"] == want["per_block"]
    e = np.empty(0, np.int64)
    assert t_m.beta_estimate(e, e, 10) == ref_m.beta_estimate(e, e, 10)
    for b in (4, 16, 32):
        assert t_m.fill_ratio(rows, cols, 300, b) == \
            ref_m.fill_ratio(rows, cols, 300, b)
    assert t_m.fill_ratio(e, e, 300, 8) == 0.0
    alive = np.random.default_rng(5).random(300) > 0.2
    g = t_m.compact_live(rows, cols, alive)
    w = ref_m.compact_live(rows, cols, alive)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])
    assert g[2] == w[2]
