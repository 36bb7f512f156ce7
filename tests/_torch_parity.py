"""Shared harness of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; the
reference's JAX arrays cross over through ``np.asarray`` and the port's
tensors through ``.numpy()``. The reference runs on the CPU, its Pallas
kernels in interpret mode; the port runs its plain versions on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

# Keep torch to one thread per test process: the suite runs under several
# xdist workers at once.
torch.set_num_threads(1)

# float32 tolerances, with their reasons
TOL = {
    # same arithmetic, different summation order / fused multiply-adds
    "f32": dict(rtol=1e-5, atol=1e-5),
    # backends against each other, unit-scale charges: the acceptance
    # bound of examples/quickstart.py
    "backend": 1e-4,
}


def tt(a):
    """numpy (or JAX) array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a))


def tn(t):
    """tensor or JAX array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_close(port, ref, kind="f32", **kw):
    tol = dict(TOL[kind])
    tol.update(kw)
    np.testing.assert_allclose(tn(port), tn(ref), **tol)


@pytest.fixture
def cuda_device():
    """Device of the card; a test that needs it skips where there is none
    (decided when the test runs, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def random_ell(seed, B, n_rb, nbr, bs, n_cb=None, pad_slots=0,
               dead_rows=()):
    """Stacked ELL-BSR members from a seed: ``pad_slots`` trailing slots of
    every row are padding (zero tile at column 0) and ``dead_rows`` row
    blocks carry no tile at all."""
    rng = np.random.default_rng(seed)
    n_cb = n_cb or n_rb
    vals = rng.standard_normal((B, n_rb, nbr, bs, bs)).astype(np.float32)
    col = np.stack([np.stack([np.sort(rng.choice(n_cb, nbr, replace=False))
                              for _ in range(n_rb)]) for _ in range(B)]
                   ).astype(np.int32)
    if pad_slots:
        vals[:, :, nbr - pad_slots:] = 0.0
        col[:, :, nbr - pad_slots:] = 0
    for r in dead_rows:
        vals[:, r] = 0.0
        col[:, r] = 0
    return vals, col


def ell_masks(seed, B, n_rb, nbr):
    """ELL slot masks of every kind the SpMV kernel must take, from a seed:
    prefixes of random length (0..nbr kept per row block), holes anywhere,
    none kept, all kept."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, nbr + 1, (B, n_rb))
    return {"prefix": np.arange(nbr) < counts[..., None],
            "holes": rng.random((B, n_rb, nbr)) < 0.5,
            "none": np.zeros((B, n_rb, nbr), bool),
            "all": np.ones((B, n_rb, nbr), bool)}


def plan_from_reference(rp):
    """A reference ``InteractionPlan`` -> port plan on the CPU, through
    numpy arrays only (``convert.plan_from_reference_arrays``)."""
    from repro_torch import convert
    b, h = rp.bsr, rp.host
    return convert.plan_from_reference_arrays(
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


def stream_plan_from_reference(rp):
    """A reference ``InteractionPlan`` -> port plan on the CPU with its
    lifecycle and streaming state (``x``, ``alive``, the per-slot codes
    and their box, ``peak_alive``, ``pending_layout``, the telemetry), so
    that it goes on refreshing and streaming as the reference's would."""
    from repro_torch import convert
    b, h = rp.bsr, rp.host
    return convert.plan_from_reference_arrays(
        dataclasses.asdict(rp.config), rp.n, np.asarray(h.pi),
        np.asarray(h.inv), tuple(np.asarray(a) for a in h.coo),
        None if b is None else np.asarray(b.col_idx),
        None if b is None else np.asarray(b.nbr_mask),
        None if b is None else np.asarray(b.vals),
        h.sigma, fill=0.0 if b is None else b.fill,
        embedding=h.embedding, embed_mean=h.embed_mean,
        embed_axes=h.embed_axes,
        tree_levels=None if h.tree is None else h.tree.levels,
        y_last=h.y_last, x=h.x, sources=h.sources,
        pattern_from_knn=h.pattern_from_knn, values_mode=h.values_mode,
        values_fn=h.values_fn, refresh=dataclasses.asdict(h.refresh),
        alive=h.alive, codes=h.codes, code_lo=h.code_lo, code_hi=h.code_hi,
        peak_alive=h.peak_alive, pending_layout=h.pending_layout,
        device="cpu")


def assert_knn_near_ties(x, rows, k):
    """ROADMAP C17: the rows where the two packages' exact kNN graphs of
    ``x`` (each point's ``k`` nearest others) differ are exactly ``rows``,
    and each is a float32 near-tie that the packages break differently.

    Both compute ``d² = |a|² + |b|² − 2ab`` in float32, and their matrix
    products round differently. Each computed distance carries up to about
    two ulps of ``|a|² + |b|²`` (the rounded norms and their sum, the
    product's accumulation), so two candidates can trade places where
    their gap is under four. At each row the first ``k − 1`` neighbours
    agree, the ``k``-th of each package is the other's ``(k + 1)``-th, and
    the exact (float64) gap between the two and each package's computed
    gap are under four such ulps.
    """
    import jax.numpy as jnp

    from repro.core import knn as ref_knn
    from repro_torch.core import knn as t_knn

    x = np.asarray(x, np.float32)
    it, dt = (tn(a) for a in t_knn.knn_graph(x, x, k + 1, exclude_self=True,
                                             device="cpu"))
    ir, dr = (tn(a) for a in ref_knn.knn_graph(
        jnp.asarray(x), jnp.asarray(x), k + 1, exclude_self=True))
    differ = [i for i in range(len(x))
              if set(it[i, :k].tolist()) != set(ir[i, :k].tolist())]
    assert differ == sorted(rows), differ
    for i in rows:
        assert set(it[i, :k - 1].tolist()) == set(ir[i, :k - 1].tolist())
        assert it[i, k - 1] == ir[i, k] and ir[i, k - 1] == it[i, k], i
        a = x[i].astype(np.float64)
        pair = [x[j].astype(np.float64) for j in (it[i, k - 1], ir[i, k - 1])]
        exact = [((a - b) ** 2).sum() for b in pair]
        ulp = max(np.spacing(np.float32(a @ a + b @ b)) for b in pair)
        assert abs(exact[0] - exact[1]) < 4 * ulp, i
        assert dt[i, k] - dt[i, k - 1] < 4 * ulp, i
        assert dr[i, k] - dr[i, k - 1] < 4 * ulp, i
