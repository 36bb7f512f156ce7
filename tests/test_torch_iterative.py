"""The paper's iterative applications (§3), port against reference.

* ``interact.tsne_attractive`` / ``meanshift_step`` (the plain blockwise
  paths, chunked over row blocks) against the reference's, including ``n``
  not divisible by ``bs``;
* the t-SNE force kernel's plain version and wrapper on the CPU against
  ``repro.kernels.ref.tsne_force_ref`` and ``repro.kernels.ops.tsne_force``
  (the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
  it), and its mask contract: only the slots ``nbr_mask`` keeps are
  summed, whatever a masked slot holds;
* ``plan.tsne_attractive`` / ``plan.meanshift_step`` on a reference plan
  carried across;
* the vectorised P calibration of ``examples/tsne_torch.py`` against the
  reference example's ``p_matrix``;
* both twin examples end to end on the CPU.

Tolerance: float32 ``rtol 1e-5`` with an ``atol`` of ``1e-5 x`` the
output's largest magnitude — the force and mean-shift sums run in another
order; ``2e-4`` where ``tests/test_kernels.py`` holds the Pallas kernel to
its oracle.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, random_ell, tn, tt

from repro import api as ref_api
from repro.core import interact as ref_interact
from repro.data.pipeline import feature_mixture
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro_torch import convert as t_convert
from repro_torch.core import interact as t_interact
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_kref
from repro_torch.kernels import tsne_force as t_tf

ROOT = Path(__file__).resolve().parents[1]


def _scaled(got, want, rtol=1e-5):
    scale = max(float(np.abs(tn(want)).max()), 1e-30)
    assert_close(got, want, rtol=rtol, atol=rtol * scale)


def _affinities(seed, n_rb, nbr, bs, n, pad_slots=1):
    """Non-negative P tiles in ELL layout, zero on padding slots and on
    the target rows past ``n`` (as a plan stores them)."""
    vals, col = random_ell(seed, 1, n_rb, min(nbr, n_rb), bs,
                           pad_slots=pad_slots)
    p = np.abs(vals[0]) / (n_rb * bs)
    rows = np.arange(n_rb)[:, None] * bs + np.arange(bs)[None, :]
    p *= (rows < n)[:, None, :, None]        # target rows past n: zero
    return p.astype(np.float32), col[0]


# ---------------------------------------------------------------------------
# the plain blockwise paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,d,n", [(8, 2, 61), (16, 3, 100), (32, 2, 96),
                                    (16, 1, 64)])
def test_tsne_attractive_matches_reference(bs, d, n):
    n_rb = -(-n // bs)
    p, col = _affinities(bs + d, n_rb, 4, bs, n)
    mask = np.ones_like(col, bool)
    mask[:, -1] = False
    y = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    want = ref_interact.tsne_attractive(jnp.asarray(p), jnp.asarray(col),
                                        jnp.asarray(mask), jnp.asarray(y), n)
    got = t_interact.tsne_attractive(tt(p), tt(col), tt(mask), tt(y), n)
    assert tuple(got.shape) == (n, d)
    _scaled(got, want)


def test_blockwise_paths_do_not_depend_on_the_chunking(monkeypatch):
    """A budget of one row block per chunk gives the same results."""
    n, bs, d = 90, 16, 2
    n_rb = -(-n // bs)
    p, col = _affinities(3, n_rb, 3, bs, n)
    y = tt(np.random.default_rng(0).standard_normal((n, d)).astype(
        np.float32))
    src = tt(np.random.default_rng(1).standard_normal((n_rb * bs, 5)).astype(
        np.float32)).reshape(n_rb, bs, 5)
    t = tt(np.random.default_rng(2).standard_normal((n, 5)).astype(
        np.float32))
    mask = torch.ones(col.shape, dtype=torch.bool)
    whole_f = t_interact.tsne_attractive(tt(p), tt(col), mask, y, n)
    whole_m = t_interact.meanshift_step(tt(p), tt(col), src, t, 3.0, n)
    monkeypatch.setattr(t_interact, "CHUNK_BYTES", 1)
    assert t_interact._row_chunk(n_rb, 3, bs, d) == 1
    _scaled(t_interact.tsne_attractive(tt(p), tt(col), mask, y, n), whole_f)
    _scaled(t_interact.meanshift_step(tt(p), tt(col), src, t, 3.0, n),
            whole_m)


@pytest.mark.parametrize("bs,d,n", [(8, 5, 61), (16, 32, 100)])
def test_meanshift_step_matches_reference(bs, d, n):
    n_rb = -(-n // bs)
    rng = np.random.default_rng(bs)
    _, col = _affinities(bs, n_rb, 4, bs, n)
    w = (rng.random((n_rb, 4, bs, bs)) > 0.6).astype(np.float32)
    w[:, -1] = 0.0
    src = rng.standard_normal((n_rb * bs, d)).astype(np.float32)
    t = (src[:n] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    h2 = float(d)
    want = ref_interact.meanshift_step(
        jnp.asarray(w), jnp.asarray(col), jnp.asarray(src).reshape(
            n_rb, bs, d), jnp.asarray(t), h2, n)
    got = t_interact.meanshift_step(tt(w), tt(col),
                                    tt(src).reshape(n_rb, bs, d), tt(t),
                                    h2, n)
    assert tuple(got.shape) == (n, d)
    _scaled(got, want)


# ---------------------------------------------------------------------------
# the kernel's plain version and wrapper (CPU tensors)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,d", [(8, 2), (16, 3), (32, 2), (16, 1)])
def test_tsne_force_plain_matches_oracles(bs, d):
    n_rb, nbr = 5, 3
    p, col = _affinities(7 * bs + d, n_rb, nbr, bs, n_rb * bs - 3)
    y = np.random.default_rng(d).standard_normal((n_rb * bs, d)).astype(
        np.float32)
    got = t_tf.tsne_force(tt(p), tt(col), tt(y))
    assert t_tf.tsne_force.launches == 0            # CPU: the plain version
    _scaled(got, ref_kref.tsne_force_ref(jnp.asarray(p), jnp.asarray(col),
                                         jnp.asarray(y)))
    _scaled(t_tf.tsne_force_plain(tt(p), tt(col), tt(y)),
            t_kref.tsne_force_ref(tt(p), tt(col), tt(y)))
    # the Pallas kernel (interpret mode) against its oracle holds 2e-4 in
    # tests/test_kernels.py; the port's plain version is held to the same
    pallas = ref_ops.tsne_force(jnp.asarray(p), jnp.asarray(col),
                                jnp.asarray(y))
    assert_close(got, pallas, rtol=2e-4, atol=2e-4)


def test_ops_tsne_force_pads_and_slices_like_reference():
    bs, n_rb, nbr, n, d = 16, 4, 3, 55, 2
    p, col = _affinities(11, n_rb, nbr, bs, n)
    y = np.random.default_rng(4).standard_normal((n, d)).astype(np.float32)
    got = t_ops.tsne_force(tt(p), tt(col).long(), tt(y).double(), n)
    want = ref_ops.tsne_force(jnp.asarray(p), jnp.asarray(col),
                              jnp.asarray(y), n)
    assert tuple(got.shape) == (n, d) and got.dtype == torch.float32
    assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert tuple(t_ops.tsne_force(tt(p), tt(col), tt(y)).shape) == \
        (n_rb * bs, d)


def test_tsne_force_rejects_what_the_kernel_does_not_take():
    p, col = _affinities(1, 2, 2, 8, 16)
    with pytest.raises(ValueError, match=r"d in \(1, 2, 3\)"):
        t_tf.tsne_force(tt(p), tt(col), torch.zeros(16, 4))
    with pytest.raises(ValueError, match="whole bs=8 column blocks"):
        t_tf.tsne_force(tt(p), tt(col), torch.zeros(12, 2))
    with pytest.raises(TypeError, match="col_idx must be int32"):
        t_tf.tsne_force(tt(p), tt(col).long(), torch.zeros(16, 2))
    with pytest.raises(ValueError, match="outside"):
        t_tf.tsne_force(tt(p), tt(col) + 5, torch.zeros(16, 2))


# ---------------------------------------------------------------------------
# the kernel's mask contract (plain version, CPU tensors)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,n", [(16, 300), (32, 300), (8, 123)])
def test_masked_tsne_force_matches_reference_on_converted_plans(bs, n):
    """On a reference plan carried across by ``convert``, the force over the
    slots ``nbr_mask`` keeps equals the reference's Pallas kernel (interpret
    mode) summing every slot: the reference's masked slots hold zero
    tiles. Through the wrapper, ``ops.tsne_force`` and the plain path."""
    x = feature_mixture(n, 16, n_clusters=6, seed=bs)
    rng = np.random.default_rng(bs + 1)
    rp = ref_api.build_plan(x, k=7, bs=bs, sb=4, backend="bsr",
                            symmetrize=True,
                            values=lambda r, c, d2: rng.random(len(r)))
    b = _cross_over(rp).bsr
    assert not bool(b.nbr_mask.all())            # there is padding to skip
    y = rng.standard_normal((n, 2)).astype(np.float32)
    want = ref_ops.tsne_force(jnp.asarray(rp.bsr.vals),
                              jnp.asarray(rp.bsr.col_idx), jnp.asarray(y), n)
    yp = torch.nn.functional.pad(tt(y), (0, 0, 0, b.n_cb * bs - n))
    got = t_tf.tsne_force(b.vals, b.col_idx, yp, b.nbr_mask)[:n]
    assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert_close(t_ops.tsne_force(b.vals, b.col_idx, tt(y), n,
                                  nbr_mask=b.nbr_mask, indices_checked=True),
                 want, rtol=2e-4, atol=2e-4)
    _scaled(t_interact.tsne_attractive(b.vals, b.col_idx, b.nbr_mask, tt(y),
                                       n), got)


def test_masked_tsne_force_ignores_nan_and_stale_columns_under_the_mask():
    """NaN tiles and out-of-range column blocks under a False bit never
    reach the force: it is finite and equal to the force without those
    slots, through the wrapper and the plain path."""
    bs, n_rb, nbr, d = 8, 5, 4, 2
    p, col = _affinities(21, n_rb, nbr, bs, n_rb * bs, pad_slots=2)
    mask = np.ones((n_rb, nbr), bool)
    mask[:, nbr - 2:] = False
    y = np.random.default_rng(2).standard_normal((n_rb * bs, d)).astype(
        np.float32)
    clean = t_tf.tsne_force(tt(p), tt(col), tt(y))
    poisoned = p.copy()
    poisoned[:, nbr - 2:] = np.nan
    stale = col.copy()
    stale[:, nbr - 1] = n_rb + 7                 # outside y's column blocks
    for got in (t_tf.tsne_force(tt(poisoned), tt(stale), tt(y), tt(mask)),
                t_tf.tsne_force_plain(tt(poisoned), tt(stale), tt(y),
                                      tt(mask)),
                t_interact.tsne_attractive(tt(poisoned), tt(stale), tt(mask),
                                           tt(y), n_rb * bs)):
        assert np.isfinite(tn(got)).all()
        np.testing.assert_array_equal(tn(got), tn(clean))


def test_masked_tsne_force_row_block_without_kept_slot_is_exact_zero():
    bs, n_rb, nbr, d = 16, 4, 3, 3
    p, col = _affinities(22, n_rb, nbr, bs, n_rb * bs, pad_slots=0)
    mask = np.ones((n_rb, nbr), bool)
    mask[1] = False
    y = np.random.default_rng(3).standard_normal((n_rb * bs, d)).astype(
        np.float32)
    got = tn(t_tf.tsne_force(tt(p), tt(col), tt(y), tt(mask)))
    assert (got[bs:2 * bs] == 0.0).all()
    assert np.abs(got[:bs]).max() > 0
    got_all = tn(t_tf.tsne_force(tt(p), tt(col), tt(y),
                                 tt(np.zeros_like(mask))))
    assert (got_all == 0.0).all()


def test_tsne_force_rejects_bad_masks_and_checks_kept_columns_only(
        monkeypatch):
    p, col = _affinities(23, 3, 2, 8, 24, pad_slots=0)
    y = torch.zeros(24, 2)
    mask = np.ones((3, 2), bool)
    with pytest.raises(ValueError, match="nbr_mask"):
        t_tf.tsne_force(tt(p), tt(col), y, tt(mask[:2]))
    with pytest.raises(TypeError, match="bool"):
        t_tf.tsne_force(tt(p), tt(col), y, tt(mask.astype(np.uint8)))
    bad = col.copy()
    bad[1, 1] = 3                          # only 3 column blocks: 0..2
    with pytest.raises(ValueError, match="col_idx range"):
        t_tf.tsne_force(tt(p), tt(bad), y, tt(mask))
    mask[1, 1] = False                     # the stale slot is not kept
    checked = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda t: checked.append(t.numel()) or aminmax(t))
    f = t_tf.tsne_force(tt(p), tt(bad), y, tt(mask))
    assert tuple(f.shape) == (24, 2)
    assert checked == [5]                  # the 5 kept slots' columns only
    # a plan's storage was checked where it was made: no check, no sync
    t_tf.tsne_force(tt(p), tt(bad), y, tt(mask), indices_checked=True)
    assert checked == [5]


# ---------------------------------------------------------------------------
# the plan hooks on a reference plan carried across
# ---------------------------------------------------------------------------


def _cross_over(rp):
    b, h = rp.bsr, rp.host
    return t_convert.plan_from_reference_arrays(
        dataclasses.asdict(rp.config), rp.n, np.asarray(h.pi),
        np.asarray(h.inv), tuple(np.asarray(a) for a in h.coo),
        np.asarray(b.col_idx), np.asarray(b.nbr_mask), np.asarray(b.vals),
        h.sigma, fill=b.fill, device="cpu")


def test_plan_tsne_attractive_backends_match_reference():
    n = 300                                    # not a multiple of bs = 32
    x = feature_mixture(n, 16, n_clusters=6, seed=3)
    rng = np.random.default_rng(5)
    rp = ref_api.build_plan(x, k=7, bs=32, sb=4, backend="bsr",
                            symmetrize=True,
                            values=lambda r, c, d2: rng.random(len(r)))
    tp = _cross_over(rp)
    y = rng.standard_normal((n, 2)).astype(np.float32)
    want = rp.tsne_attractive(jnp.asarray(y))
    for backend in (None, "auto", "bsr", "cuda"):
        got = tp.tsne_attractive(y if backend else tt(y), backend=backend)
        assert tuple(got.shape) == (n, 2)
        _scaled(got, want)
    assert_close(tp.tsne_attractive(tt(y), backend="cuda"),
                 rp.tsne_attractive(jnp.asarray(y), backend="pallas"),
                 rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="unknown tsne_attractive backend"):
        tp.tsne_attractive(tt(y), backend="pallas")


def test_plan_meanshift_step_matches_reference():
    n, d = 200, 12
    src = feature_mixture(n, d, n_clusters=4, seed=6)
    t = src + 0.1 * np.random.default_rng(7).standard_normal(
        src.shape).astype(np.float32)
    rp = ref_api.build_plan(t, k=9, sources=src, bs=16, sb=4, backend="bsr")
    tp = _cross_over(rp)
    t_s, s_s = rp.permute(t), rp.permute(src)
    want = rp.meanshift_step(jnp.asarray(t_s), jnp.asarray(s_s), 1.5)
    got = tp.meanshift_step(tt(t_s), s_s, 1.5)   # numpy is accepted too
    assert tuple(got.shape) == (n, d)
    _scaled(got, want)


# ---------------------------------------------------------------------------
# the twin examples
# ---------------------------------------------------------------------------


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vectorised_p_calibration_matches_reference_example(monkeypatch):
    """The calibration and symmetrisation alone: the port example is
    handed the reference's kNN graph (the two packages' float32 distances
    differ by cancellation noise, which exp(-beta d2) would magnify)."""
    from repro.core import knn as ref_knn
    ref_ex = _load(ROOT / "examples" / "tsne.py", "_ref_tsne_example")
    t_ex = _load(ROOT / "examples" / "tsne_torch.py", "_torch_tsne_example")

    class RefKnn:
        @staticmethod
        def knn_graph(t, s, k, exclude_self=False, device=None):
            idx, d2 = ref_knn.knn_graph(jnp.asarray(t), jnp.asarray(s), k,
                                        exclude_self=exclude_self)
            return tt(np.asarray(idx)).long(), tt(np.asarray(d2))

    monkeypatch.setattr(t_ex, "knn", RefKnn)
    x = feature_mixture(512, 128, n_clusters=8, seed=1)
    # perplexity 5 is reachable with 16 neighbors (the bisection really
    # calibrates); perplexity 30 is not, and pins beta at its lower bound
    for k, perp in ((16, 5.0), (16, 30.0)):
        rr, rc, rv = ref_ex.p_matrix(x, k, perplexity=perp)
        tr, tc, tv = t_ex.p_matrix(x, k, perplexity=perp, device="cpu")
        np.testing.assert_array_equal(tn(tr), rr)
        np.testing.assert_array_equal(tn(tc), rc)
        assert_close(tv, rv, rtol=1e-5, atol=0)


def _run_example(args, timeout=900):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_tsne_twin_example_on_cpu():
    r = _run_example([str(ROOT / "examples" / "tsne_torch.py"),
                      "--device", "cpu", "--n", "512", "--iters", "220",
                      "--k", "16"])
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "clusters separated OK" in r.stdout
    assert "refresh:" in r.stdout


def test_meanshift_twin_example_on_cpu():
    r = _run_example([str(ROOT / "examples" / "meanshift_torch.py"),
                      "--device", "cpu"])
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "converged to modes OK" in r.stdout
