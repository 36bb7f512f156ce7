"""The plain references against independent computations at tiny sizes:
the plan's product against a dense float64 product, the MLA decoder
against the program's train step computed in float32."""
import numpy as np
import torch

from perfbench.harness import gen
from perfbench.reference import knn
from perfbench.tests import tiny


def test_product_rows_equal_a_dense_product():
    x = gen.feature_mixture(600, 16, 4, 3, 0.15).astype(np.float64)
    k, h = 7, 0.5
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dense = np.zeros_like(d2)
    rows = np.arange(600)[:, None]
    dense[rows, nbr] = np.exp(-d2[rows, nbr] / h)
    ch = np.random.default_rng(1).standard_normal((600, 3))
    xt = torch.as_tensor(x)
    sel = torch.arange(0, 600, 7)
    idx, dd, gap, scale = knn.neighbors(xt, sel, k)
    got = knn.product_rows(idx, dd, torch.as_tensor(ch), h)
    np.testing.assert_allclose(got.numpy(), (dense @ ch)[sel.numpy()],
                               rtol=1e-10, atol=1e-12)
    assert (gap >= 0).all() and (scale > 0).all()


def test_tf32_rounding():
    a = torch.randn(10000) * 1e3
    r = knn.round_tf32(a)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - a).abs() <= a.abs() * 2.0 ** -11).all()
    assert knn.round_tf32(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0


def test_tf32_control_moves_neighbors():
    x = torch.as_tensor(gen.feature_mixture(2048, 128, 16, 4, 0.15))
    rows = torch.arange(0, 2048, 16)
    exact, _, _, _ = knn.neighbors(x, rows, 30)
    low, _, _, _ = knn.neighbors(x, rows, 30, tf32=True)
    same = [len(set(a.tolist()) & set(b.tolist())) for a, b in
            zip(exact, low)]
    assert min(same) < 30


def test_sift_cells_correct_at_a_tiny_size():
    for cell in ("sift-262k.matvec8", "sift-262k.build"):
        res, checks = tiny.run(cell, tiny.SIFT)
        assert res["correct"], checks
        assert res["attempted"] >= 1 and res["failed"] == 0


def test_mla_reference_matches_the_program_in_float32():
    res, checks = tiny.run("minicpm3-4b.train2k", tiny.MLA)
    got = dict((n, v) for n, v, _ in checks)
    assert res["correct"], checks
    assert got["loss_rel_gap"] < 1e-5
    assert got["grad1_leaf_gap"] < 1e-4
    assert got["change_leaf_gap"] < 1e-4
