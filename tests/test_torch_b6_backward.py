"""B6's backward (ClusterKV training) on the CPU: the plain backward, the
key-tile lists and the differentiable ops.

- ``block_attention_backward_plain`` against ``jax.vjp`` of the
  reference's ``core.clusterkv.sparse_block_attention`` (the XLA path its
  ``jax.grad`` trains through), on the same numpy q, k, v, positions,
  ``idx`` and cotangent: causal and not, GQA with g in {1, 2, 3}, dh != dv,
  a duplicate tile id and a query row whose selected keys are all masked;
  also through ``ops.block_attention`` under autograd (the op's CPU
  implementations). Tolerance ``GRAD_TOL x`` the largest value of the
  reference's gradient: float32 sums in another order (the reference
  differentiates its online softmax step by step, the port applies the
  closed form with the final m and l).
- The plain backward against autograd of the plain forward in float64,
  within ``F64_TOL x scale``.
- The same against ``jax.vjp`` at the shapes the Hopper kernels take
  (tiles of 128, dh 64, 128 and 96 with dv 64) and with skewed
  selections: one key tile chosen by every query tile (g = 7 and 1), a
  key tile chosen by none, whose dk and dv are exactly 0.
- ``key_tile_lists_plain`` against a numpy transpose of ``idx``, with
  tile ids outside ``[0, S_k/bk)`` and duplicates; ``key_tile_order_plain``
  (the dK/dV blocks' order, longest list first) against a numpy sort.
- The forward and backward ops under ``FakeTensorMode`` on fake CUDA
  tensors: shapes, dtypes, no ``data_ptr()`` read (warnings are errors),
  no launch counted, and ``FlopCounterMode`` counting the backward's
  formula ``2 bq bk (2 dh + dv) + 2 bq bk (2 dh + 2 dv)`` per selected
  tile pair beside the forward's ``2 bq bk (dh + dv)``.

The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clusterkv as r_ckv
from repro_torch.core import clusterkv as t_ckv
from repro_torch.kernels import block_attention as t_ba
from repro_torch.kernels import ops as t_ops

GRAD_TOL = 2e-5
F64_TOL = 1e-12


def _inputs(seed, b, hq, hkv, s, dh, dv, bq, n_sel, *, dup=False,
            masked_row=False, hot=None, dtype=np.float32):
    """Seeded numpy inputs: cluster-sorted k/v with a permuted position per
    key, ``n_sel`` distinct key tiles per query tile; ``dup`` repeats one
    tile id in a slot, ``masked_row`` selects for query tile 0 only tiles
    that do not hold position 0, so query row 0 sees no unmasked key;
    ``hot`` (a tile id) is chosen by every query tile, in slot 0, and the
    last key tile by none."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, dh)).astype(dtype)
    k = rng.standard_normal((b, hkv, s, dh)).astype(dtype)
    v = rng.standard_normal((b, hkv, s, dv)).astype(dtype)
    kpos = np.stack([rng.permutation(s) for _ in range(b * hkv)]).reshape(
        b, hkv, s).astype(np.int32)
    qpos = np.arange(s, dtype=np.int32)
    nqb, nkb = s // bq, s // bq
    idx = np.argsort(rng.random((b, hkv, nqb, nkb)), -1)[..., :n_sel]
    if masked_row:
        for bi in range(b):
            for hi in range(hkv):
                zero_tile = int(np.argmax(kpos[bi, hi] == 0)) // bq
                others = [t for t in range(nkb) if t != zero_tile]
                idx[bi, hi, 0] = others[:n_sel]
    if hot is not None:
        rest = [t for t in range(nkb - 1) if t != hot]
        for bi in range(b):
            for hi in range(hkv):
                for qt in range(nqb):
                    idx[bi, hi, qt] = [hot, *rng.permutation(rest)[
                        :n_sel - 1]]
    if dup:
        idx[0, 0, 1, 1] = idx[0, 0, 1, 0]
    return q, k, v, kpos, qpos, idx.astype(np.int32)


CASES = [
    # (causal, g, dh, dv, dup, masked_row)
    (True, 1, 16, 16, False, False),
    (True, 2, 16, 8, True, False),
    (True, 3, 8, 16, False, True),
    (False, 1, 8, 16, True, False),
    (False, 2, 16, 16, False, False),
    (False, 3, 16, 8, False, False),
    (True, 2, 16, 16, True, True),
]


@pytest.mark.parametrize("causal,g,dh,dv,dup,masked_row", CASES)
def test_plain_backward_matches_the_reference_vjp(causal, g, dh, dv, dup,
                                                  masked_row):
    bq = 16
    q, k, v, kpos, qpos, idx = _inputs(1, 2, 2 * g, 2, 64, dh, dv, bq, 3,
                                       dup=dup, masked_row=masked_row)
    if masked_row:
        sel = idx[0, 0, 0]
        assert (kpos[0, 0].reshape(-1, bq)[sel] > qpos[0]).all()
    cot = np.random.default_rng(2).standard_normal(
        (2, 2 * g, 64, dv)).astype(np.float32)

    def f(q_, k_, v_):
        return r_ckv.sparse_block_attention(q_, k_, v_, jnp.asarray(kpos),
                                            jnp.asarray(qpos),
                                            jnp.asarray(idx), bq, bq,
                                            causal=causal)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(cot))]

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkp, tqp, tix = map(torch.from_numpy, (kpos, qpos, idx))
    tcot = torch.from_numpy(cot)
    out, m, l = t_ckv.sparse_block_attention(tq, tk, tv, tkp, tqp, tix, bq,
                                             bq, causal=causal, stats=True)
    got = t_ba.block_attention_backward_plain(
        tq, tk, tv, tkp, tqp, tix, out, torch.stack([m, l]), tcot, bq=bq,
        bk=bq, causal=causal)
    # the same through the op, under autograd (its CPU implementations)
    live = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    n0 = (t_ba.block_attention.launches,
          t_ba.block_attention_backward.launches)
    o = t_ops.block_attention(*live, tkp, tqp, tix, bq=bq, bk=bq,
                              causal=causal)
    via_op = torch.autograd.grad(o, live, tcot)
    assert (t_ba.block_attention.launches,
            t_ba.block_attention_backward.launches) == n0
    for name, w, a, c in zip(("dq", "dk", "dv"), want, got, via_op):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
        np.testing.assert_allclose(c.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    if masked_row:
        # the masked row passes nothing to q; v still receives 1 / l
        assert float(np.abs(want[0][0, 0, 0]).max()) == 0.0
        assert float(got[0][0, 0, 0].abs().max()) == 0.0


# the Hopper kernels' shapes and skewed selections, at small S:
# (causal, g, dh, dv, bq, s, hot, dup, masked_row); ``hot`` chosen by every
# query tile, the last key tile by none
WIDE_CASES = [
    (True, 7, 64, 64, 16, 128, 0, False, False),
    (True, 1, 64, 64, 16, 128, 2, True, False),
    (False, 7, 32, 16, 16, 128, 5, False, False),
    (True, 2, 128, 128, 128, 512, None, True, True),
    (False, 1, 128, 128, 128, 512, 1, False, False),
    (True, 2, 96, 64, 128, 512, None, False, True),
    (True, 1, 96, 64, 128, 384, 0, True, False),
]


@pytest.mark.parametrize("causal,g,dh,dv,bq,s,hot,dup,masked_row",
                         WIDE_CASES)
def test_plain_backward_matches_the_reference_vjp_wide_and_skewed(
        causal, g, dh, dv, bq, s, hot, dup, masked_row):
    n_sel = 2 if s // bq <= 4 else 3
    q, k, v, kpos, qpos, idx = _inputs(6, 1, 2 * g, 2, s, dh, dv, bq, n_sel,
                                       dup=dup, masked_row=masked_row,
                                       hot=hot)
    if hot is not None:
        assert (idx[..., 0] == hot).all() and (idx != s // bq - 1).all()
    cot = np.random.default_rng(7).standard_normal(
        (1, 2 * g, s, dv)).astype(np.float32)

    def f(q_, k_, v_):
        return r_ckv.sparse_block_attention(q_, k_, v_, jnp.asarray(kpos),
                                            jnp.asarray(qpos),
                                            jnp.asarray(idx), bq, bq,
                                            causal=causal)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(cot))]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkp, tqp, tix = map(torch.from_numpy, (kpos, qpos, idx))
    out, m, l = t_ckv.sparse_block_attention(tq, tk, tv, tkp, tqp, tix, bq,
                                             bq, causal=causal, stats=True)
    got = t_ba.block_attention_backward_plain(
        tq, tk, tv, tkp, tqp, tix, out, torch.stack([m, l]),
        torch.from_numpy(cot), bq=bq, bk=bq, causal=causal)
    for name, w, a in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(w).max()),
                                   err_msg=name)
    if hot is not None:
        # the last key tile is chosen by none: its gradients are exactly 0
        for a in got[1:]:
            assert float(a[:, :, -bq:].abs().max()) == 0.0


@pytest.mark.parametrize("causal,g,dh,dv,dup,masked_row", CASES)
def test_plain_backward_matches_autograd_of_the_plain_forward_f64(
        causal, g, dh, dv, dup, masked_row):
    bq = 16
    q, k, v, kpos, qpos, idx = _inputs(3, 2, 2 * g, 2, 64, dh, dv, bq, 3,
                                       dup=dup, masked_row=masked_row,
                                       dtype=np.float64)
    tkp, tqp, tix = map(torch.from_numpy, (kpos, qpos, idx))
    live = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = t_ckv.sparse_block_attention(*live, tkp, tqp, tix, bq, bq,
                                       causal=causal)
    assert out.dtype == torch.float64
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(out.shape)))
    want = torch.autograd.grad(out, live, cot)
    got = t_ba.block_attention_backward_plain(
        *[t.detach() for t in live], tkp, tqp, tix, out.detach(), None,
        cot, bq=bq, bk=bq, causal=causal)
    for name, w, a in zip(("dq", "dk", "dv"), want, got):
        assert a.dtype == torch.float64
        scale = float(w.abs().max())
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                   atol=F64_TOL * scale, err_msg=name)


def _lists_numpy(idx, nkb):
    b, hkv = idx.shape[:2]
    flat = idx.reshape(b, hkv, -1)
    n = flat.shape[2]
    off = np.zeros((b, hkv, nkb + 1), np.int32)
    ent = np.full((b, hkv, n), -1, np.int32)
    for bi in range(b):
        for hi in range(hkv):
            row = [[j for j in range(n) if flat[bi, hi, j] == t]
                   for t in range(nkb)]
            off[bi, hi, 1:] = np.cumsum([len(r) for r in row])
            lst = [j for r in row for j in r]
            ent[bi, hi, :len(lst)] = lst
    return off, ent


@pytest.mark.parametrize("nkb,n_sel,seed", [(4, 2, 0), (8, 3, 1), (3, 5, 2)])
def test_key_tile_lists_are_the_transpose_of_idx(nkb, n_sel, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nkb, (2, 3, 5, n_sel)).astype(np.int32)
    idx[0, 0, 0, 0] = nkb            # outside the cache: listed nowhere
    idx[1, 2, 4, n_sel - 1] = -1
    idx[0, 1, 2, :2] = idx[0, 1, 2, 0]  # a duplicate id
    off, ent = t_ba.key_tile_lists_plain(torch.from_numpy(idx), nkb)
    want_off, want_ent = _lists_numpy(idx, nkb)
    assert off.dtype == ent.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(ent.numpy(), want_ent)
    assert int(off[0, 0, -1]) == idx[0, 0].size - 1
    # the CPU wrapper is the plain version
    n0 = t_ba.key_tile_lists.launches
    off2, ent2 = t_ba.key_tile_lists(torch.from_numpy(idx), nkb)
    assert t_ba.key_tile_lists.launches == n0
    assert torch.equal(off2, off) and torch.equal(ent2, ent)


def _order_numpy(off):
    n = (off[..., 1:] - off[..., :-1]).reshape(-1)
    return np.array(sorted(range(n.size), key=lambda i: (-n[i], i)),
                    np.int32)


@pytest.mark.parametrize("nkb,n_sel,seed,hot", [
    (4, 2, 0, None), (8, 3, 1, 3), (32, 16, 2, 0), (3, 5, 3, None)])
def test_key_tile_order_is_longest_list_first(nkb, n_sel, seed, hot):
    """The order the dK/dV blocks are numbered in: every (b, kv head, key
    tile) once, by list length, longest first, equal lengths in index
    order; on the CPU the wrapper is the plain version."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, nkb + 1, (2, 3, 5, n_sel)).astype(np.int32)
    if hot is not None:
        idx[..., 0] = hot            # one tile chosen by every query tile
    off, _ = t_ba.key_tile_lists_plain(torch.from_numpy(idx), nkb)
    order = t_ba.key_tile_order_plain(off)
    assert order.dtype == torch.int32 and order.shape == (2 * 3 * nkb,)
    np.testing.assert_array_equal(order.numpy(), _order_numpy(off.numpy()))
    assert sorted(order.tolist()) == list(range(2 * 3 * nkb))
    n0 = t_ba.key_tile_order.launches
    assert torch.equal(t_ba.key_tile_order(off), order)
    assert t_ba.key_tile_order.launches == n0


@pytest.mark.parametrize("dh,dv", [(64, 64), (96, 64)])
def test_b6_train_ops_trace_under_fake_cuda_tensors(dh, dv):
    """Fake CUDA tensors (no card needed): ``block_attention_with_stats``
    gives the output and float32 statistics, and
    ``block_attention_backward``, called as autograd calls it
    (``_backward``), gradients of the inputs' shapes and dtypes; no
    warning, no launch counted, FLOPs by the ops' formulas. No autograd
    graph is built here: this CPU-only build of PyTorch aborts on one over
    CUDA tensors, fake or not (the CPU tests above drive the same
    formula through the engine; on a machine with CUDA the dry run traces
    it)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, hq, hkv, s, bq, n_sel = 2, 14, 2, 512, 128, 2
    launches = (t_ba.block_attention.launches, t_ba.key_tile_lists.launches,
                t_ba.block_attention_backward.launches)
    pairs = b * hq * (s // bq) * n_sel
    fwd = 2 * bq * bq * (dh + dv) * pairs
    bwd = 2 * bq * bq * ((2 * dh + dv) + (2 * dh + 2 * dv)) * pairs
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with FakeTensorMode():
            def t(*shape, dtype=torch.bfloat16):
                return torch.empty(shape, dtype=dtype, device="cuda")
            q, k, v = t(b, hq, s, dh), t(b, hkv, s, dh), t(b, hkv, s, dv)
            pos, qpos = t(b, hkv, s, dtype=torch.int32), t(s, dtype=torch.int32)
            idx = t(b, hkv, s // bq, n_sel, dtype=torch.int32)
            with FlopCounterMode(display=False) as fc:
                out, stats = torch.ops.repro_torch.block_attention_with_stats(
                    q, k, v, pos, qpos, idx, bq, bq, True)
            assert isinstance(out, FakeTensor)
            assert (tuple(out.shape), out.dtype, out.device.type) == \
                ((b, hq, s, dv), torch.bfloat16, "cuda")
            assert {str(op): n for op, n in fc.get_flop_counts()[
                "Global"].items()} == {
                    "repro_torch.block_attention_with_stats": fwd}
            assert (tuple(stats.shape), stats.dtype) == \
                ((2, b, hq, s), torch.float32)

            class Ctx:
                saved_tensors = (q, k, v, pos, qpos, idx, out, stats)
                tiles = (bq, bq, True)
            with FlopCounterMode(display=False) as fc:
                grads = t_ba._backward(Ctx, torch.ones_like(out), None)
            assert grads[3:] == (None,) * 6
            for gt, x in zip(grads, (q, k, v)):
                assert isinstance(gt, FakeTensor)
                assert (tuple(gt.shape), gt.dtype, gt.device.type) == \
                    (tuple(x.shape), torch.bfloat16, "cuda")
            assert {str(op): n for op, n in fc.get_flop_counts()[
                "Global"].items()} == {
                    "repro_torch.block_attention_backward": bwd}
    assert (t_ba.block_attention.launches, t_ba.key_tile_lists.launches,
            t_ba.block_attention_backward.launches) == launches


def test_no_grad_keeps_the_forward_op():
    """Without grad the wrapper runs the forward-only op (no statistics
    written); under grad on the CPU the differentiable op, whose output
    equals the plain forward's bit for bit."""
    q, k, v, kpos, qpos, idx = map(torch.from_numpy, _inputs(
        5, 1, 4, 2, 64, 16, 16, 16, 2))
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=16, bk=16)
    got = t_ops.block_attention(q.requires_grad_(), k, v, kpos, qpos, idx,
                                bq=16, bk=16)
    assert got.requires_grad and torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(t_ops.block_attention(q, k, v, kpos, qpos, idx,
                                                 bq=16, bk=16), want)
