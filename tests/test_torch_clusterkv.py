"""ClusterKV core (``core/clusterkv.py``) and the plain versions of kernels
B5 and B6, against the reference on the same numpy inputs.

Integer artifacts (cluster orderings, ``select_blocks``/``decode_select``
tile indices) must be exactly equal; float32 outputs within ``rtol 1e-5``.
B6's plain version is held against ``ref.block_attention_ref`` and against
the reference's ``ops.block_attention`` (its Pallas kernel in interpret
mode); B5's plain version against ``decode_select + decode_attend`` (plain
mode) and ``_plan_decode_xla`` (plan mode) — the reference's fused kernel
itself does not run on this JAX (ROADMAP C1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt

from repro.core import clusterkv as r_ckv
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.configs.base import ClusterKVConfig as RCKV
from repro.models import attention as r_attn
from repro_torch.core import clusterkv as t_ckv
from repro_torch.kernels import block_attention as t_ba
from repro_torch.kernels import decode_attend as t_da
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

BIG = 2 ** 31 - 1


def _rng(seed):
    return np.random.default_rng(seed)


def _clustered_keys(seed, b=1, h=2, s=128, dh=16, n_clusters=4):
    rng = _rng(seed)
    cc = rng.standard_normal((n_clusters, dh)) * 4.0
    asg = rng.integers(0, n_clusters, (b, h, s))
    return (cc[asg] + 0.3 * rng.standard_normal((b, h, s, dh))
            ).astype(np.float32)


def test_topk_stable_breaks_ties_like_lax_top_k():
    scores = np.array([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30, 0.5, -1e30]],
                      np.float32)
    got = tn(t_ckv.topk_stable(tt(scores), 6))
    import jax
    _, want = jax.lax.top_k(jnp.asarray(scores), 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[0], [1, 2, 4, 0, 6, 3])


# -- C15: B5's rank rule with NaN scores ---------------------------------


def _b5_rank_select(scores, n_sel):
    """NumPy emulation of B5's selection (``csrc/decode_attend.cu``,
    ``ranks_above``): a tile's rank is the number of tiles before it under
    NaN first, then descending, two NaNs equal, ties to the lowest index;
    the tile of rank r < n_sel lands in slot r."""
    s = np.asarray(scores, np.float32)
    flat = s.reshape(-1, s.shape[-1])
    idx = np.arange(flat.shape[1])
    out = np.full((flat.shape[0], n_sel), -1, np.int64)
    with np.errstate(invalid="ignore"):
        for r, row in enumerate(flat):
            nan = np.isnan(row)
            for t in idx:
                above = np.where(nan != nan[t], nan,
                                 (~nan & (row > row[t]))
                                 | ((nan | (row == row[t])) & (idx < t)))
                rank = int(above.sum())
                if rank < n_sel:
                    out[r, rank] = t
    assert (out >= 0).all()            # every rank below n_sel taken once
    return out.reshape(s.shape[:-1] + (n_sel,))


_NAN, _INF = float("nan"), float("inf")
_NAN_SCORES = [
    [1.0, _NAN, 2.0, -_INF, 0.5],                       # ROADMAP C15's row
    [_NAN, 3.0, _INF, _NAN, 3.0, -1e30, _INF, -1e30, 3.0, -_INF, _NAN],
    [-1e30, -1e30, _NAN, -1e30, 1e4 + 0.5, -_INF, 1e4 + 0.5, _NAN],
    [_INF, -_INF, _INF, -_INF, 0.0],
]


@pytest.mark.parametrize("row", range(len(_NAN_SCORES)))
def test_topk_stable_ranks_nan_and_infinities_like_lax_top_k(row):
    """ROADMAP C15: NaN ranks above +inf, two NaNs tie, ties go to the
    lowest index — in ``lax.top_k``, in ``topk_stable`` and in B5's rank
    rule (emulated), for every k."""
    import jax
    scores = np.array([_NAN_SCORES[row]], np.float32)
    for k in range(1, scores.shape[1] + 1):
        got = tn(t_ckv.topk_stable(tt(scores), k))
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(_b5_rank_select(scores, k), got)
    if row == 0:
        np.testing.assert_array_equal(got[0, :3], [1, 2, 0])


@pytest.mark.parametrize("seed", range(4))
def test_b5_rank_rule_equals_topk_stable_and_lax_top_k(seed):
    """Random scores drawn from a pool of NaN, +-inf, NEG_INF, boosted and
    plain values (many ties), mixed with normal draws: the emulated rank
    rule gives ``topk_stable``'s and ``lax.top_k``'s indices in their
    order."""
    import jax
    rng = _rng(70 + seed)
    pool = np.array([_NAN, _INF, -_INF, -1e30, 1e4, 0.5, -2.0, 3.0],
                    np.float32)
    scores = rng.choice(pool, (3, 2, 40))
    scores = np.where(rng.random(scores.shape) < 0.3,
                      rng.standard_normal(scores.shape), scores
                      ).astype(np.float32)
    for n_sel in (1, 7, 16, 40):
        emu = _b5_rank_select(scores, n_sel)
        np.testing.assert_array_equal(
            emu, tn(t_ckv.topk_stable(tt(scores), n_sel)))
        _, want = jax.lax.top_k(jnp.asarray(scores), n_sel)
        np.testing.assert_array_equal(emu, np.asarray(want))


def test_topk_stable_and_lax_top_k_differ_on_signed_zeros_and_negative_nan():
    """ROADMAP C16: ``lax.top_k`` orders by IEEE 754's total order, -0
    below +0 and a NaN with its sign bit set below -inf; ``topk_stable``
    (a stable descending sort) and B5's rank rule take -0 == +0 (a tie,
    to the lowest index) and every NaN above +inf."""
    import jax
    scores = np.array([[-0.0, 0.0, -np.float32(_NAN), 1.0]], np.float32)
    assert np.signbit(scores[0, 2])
    emu = _b5_rank_select(scores, 4)
    np.testing.assert_array_equal(emu, tn(t_ckv.topk_stable(tt(scores), 4)))
    np.testing.assert_array_equal(emu[0], [2, 3, 0, 1])
    _, want = jax.lax.top_k(jnp.asarray(scores), 4)
    np.testing.assert_array_equal(np.asarray(want)[0], [3, 1, 0, 2])


@pytest.mark.parametrize("all_masked_row", [False, True])
def test_masked_softmax_matches_reference(all_masked_row):
    rng = _rng(1)
    logit = rng.standard_normal((3, 5, 9)).astype(np.float32)
    mask = rng.random((3, 5, 9)) > 0.3
    if all_masked_row:
        mask[1, 2] = False
    got = t_ckv.masked_softmax(tt(logit), tt(mask))
    want = r_ckv.masked_softmax(jnp.asarray(logit), jnp.asarray(mask))
    assert_close(got, want)
    if all_masked_row:
        assert (tn(got)[1, 2] == 0).all()


@pytest.mark.parametrize("g", [1, 3])
def test_decode_logits_and_combine(g):
    rng = _rng(2)
    qh = rng.standard_normal((g, 16)).astype(np.float32)
    ks = rng.standard_normal((40, 16)).astype(np.float32)
    w = rng.random((g, 40)).astype(np.float32)
    assert_close(t_ckv.decode_logits(tt(qh), tt(ks)),
                 r_ckv.decode_logits(jnp.asarray(qh), jnp.asarray(ks)))
    assert_close(t_ckv.decode_combine(tt(w), tt(ks)),
                 r_ckv.decode_combine(jnp.asarray(w), jnp.asarray(ks)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_cluster_perm_equals_reference(d):
    """ROADMAP C9: on the CPU the ordering equals the reference's — off
    Morton near-ties, where the two packages' float32 embeddings put a
    key on either side of a cell edge (C31, the test after this one)."""
    k = _clustered_keys(3, b=2, h=3, s=96, dh=12)
    got = t_ckv.cluster_perm(tt(k), d=d)
    want = r_ckv.cluster_perm(jnp.asarray(k), d=d)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(tn(got), np.asarray(want))


def test_cluster_perm_off_a_morton_near_tie_equals_reference():
    """ROADMAP C31: ROADMAP C30's keys rounded to bf16 and passed as
    float32, default ``embed_dim`` 3. Key 89 of head 0 sits on a cell
    edge: the packages' embedding boxes differ by one float32 ulp, so its
    first coordinate quantizes to 1008.00006 in the reference and
    1007.99994 in the port (6e-5 of a cell either side of the edge at
    1008), and its Morton code is 766433698 against 766430187. It moves
    from cluster position 291 to 286, across the tile edge at 288, and
    the five keys between shift by one. Everything else — head 1, every
    other code, the permutation with key 89 taken out — is exact. The
    embedding's sum order is not changed to chase the bits (values are
    close, not bitwise)."""
    from repro.core.clusterkv import _pca_project
    from repro.core.hierarchy import morton_codes as r_morton
    from repro_torch.core.embedding import pca_project_det
    from repro_torch.core.hierarchy import morton_codes as t_morton

    rng = _rng(0)
    rng.standard_normal((1, 14, 512, 64))             # C30's q draw
    centers = rng.standard_normal((8, 64)).astype(np.float32) * 3
    k = (centers[rng.integers(0, 8, (1, 2, 512))]
         + 0.3 * rng.standard_normal((1, 2, 512, 64))).astype(np.float32)
    k = tt(k).to(torch.bfloat16).float().numpy()
    got = tn(t_ckv.cluster_perm(tt(k)))
    want = np.asarray(r_ckv.cluster_perm(jnp.asarray(k)))
    np.testing.assert_array_equal(got[0, 1], want[0, 1])
    differ = np.nonzero(got[0, 0] != want[0, 0])[0]
    np.testing.assert_array_equal(differ, np.arange(286, 292))
    assert (int(np.nonzero(want[0, 0] == 89)[0][0]),
            int(np.nonzero(got[0, 0] == 89)[0][0])) == (291, 286)
    np.testing.assert_array_equal(got[0, 0][got[0, 0] != 89],
                                  want[0, 0][want[0, 0] != 89])
    yr = np.asarray(_pca_project(jnp.asarray(k[0, 0]), 3))
    yt = tn(pca_project_det(tt(k[0, :1]), 3, device="cpu")[0])
    assert np.abs(yr - yt).max() < 1e-5
    cr = np.asarray(r_morton(jnp.asarray(yr), 10))
    ct = tn(t_morton(tt(yt)[None], 10, device="cpu")[0])
    np.testing.assert_array_equal(np.nonzero(cr != ct)[0], [89])
    assert (int(cr[89]), int(ct[89])) == (766433698, 766430187)
    for y, cell in ((yr, 1008), (yt, 1007)):
        lo, hi = y.min(0), y.max(0)
        t = (y[89, 0] - lo[0]) / (hi[0] - lo[0]) * 1023
        assert np.floor(t) == cell and abs(t - 1008) < 1e-4


def test_permute_kv_and_block_centroids():
    rng = _rng(4)
    k = rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 2, 64)).copy()
    perm = np.stack([np.stack([rng.permutation(64) for _ in range(2)])
                     for _ in range(2)]).astype(np.int32)
    got = t_ckv.permute_kv(tt(k), tt(v), tt(pos), tt(perm))
    want = r_ckv.permute_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(perm))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(tn(a), np.asarray(b))
    assert_close(t_ckv.block_centroids(got[0], 16),
                 r_ckv.block_centroids(want[0], 16))


def _selection_inputs(seed, b=2, h=2, nqb=6, nkb=8, dh=8, bk=16):
    rng = _rng(seed)
    qc = rng.standard_normal((b, h, nqb, dh)).astype(np.float32)
    kc = rng.standard_normal((b, h, nkb, dh)).astype(np.float32)
    pos = np.stack([np.stack([rng.permutation(nkb * bk) for _ in range(h)])
                    for _ in range(b)]).reshape(b, h, nkb, bk)
    pos[0, 0, 3] = BIG                       # one whole hole tile
    kmin = pos.min(-1).astype(np.int32)
    kmax = np.where(pos == BIG, -1, pos).max(-1).astype(np.int32)
    qpos = np.arange(nqb * bk, dtype=np.int32).reshape(nqb, bk)
    return qc, kc, kmin, kmax, qpos.min(-1), qpos.max(-1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_sel", [1, 3, 8])
def test_select_blocks_indices_exactly_equal(causal, n_sel):
    qc, kc, kmin, kmax, qmin, qmax = _selection_inputs(5)
    args = (qc, kc, kmin, kmax, qmin, qmax)
    got = t_ckv.select_blocks(*map(tt, args), n_sel, 16, causal=causal,
                              local_window=16)
    want = r_ckv.select_blocks(*map(jnp.asarray, args), n_sel, 16,
                               causal=causal, local_window=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tn(got), np.asarray(want))


def _tile_inputs(seed, b=2, hq=4, hkv=2, s=128, dh=16, bq=32, bk=32, n_sel=3):
    rng = _rng(seed)
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    kpos = np.stack([np.stack([rng.permutation(s) for _ in range(hkv)])
                     for _ in range(b)]).astype(np.int32)
    qpos = np.arange(s, dtype=np.int32)
    idx = np.stack([np.stack([np.stack([
        rng.choice(s // bk, n_sel, replace=False) for _ in range(s // bq)])
        for _ in range(hkv)]) for _ in range(b)]).astype(np.int32)
    return q, k, v, kpos, qpos, idx


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(32, 32), (16, 32), (32, 16)])
def test_sparse_block_attention_matches_reference(causal, bq, bk):
    args = _tile_inputs(6, bq=bq, bk=bk)
    got = t_ckv.sparse_block_attention(*map(tt, args), bq, bk, causal=causal)
    want = r_ckv.sparse_block_attention(*map(jnp.asarray, args), bq, bk,
                                        causal=causal)
    assert_close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_b6_plain_version_matches_oracle_and_interpret_kernel(causal):
    """The port's B6 wrapper on CPU tensors (its plain version) against the
    reference's single-slice oracle and its Pallas kernel in interpret
    mode through ``ops.block_attention``."""
    args = _tile_inputs(7 if causal else 8)
    q, k, v, kpos, qpos, idx = args
    n0 = t_ba.block_attention.launches
    got = t_ops.block_attention(*map(tt, args), bq=32, bk=32, causal=causal)
    assert t_ba.block_attention.launches == n0          # CPU: no launch
    want = r_ops.block_attention(*map(jnp.asarray, args), bq=32, bk=32,
                                 causal=causal)
    assert_close(got, want)
    g = 2
    for bi, h in ((0, 1), (1, 3)):
        kh = h // g
        oracle = r_ref.block_attention_ref(
            jnp.asarray(q[bi, h]), jnp.asarray(k[bi, kh]),
            jnp.asarray(v[bi, kh]), jnp.asarray(kpos[bi, kh]),
            jnp.asarray(qpos), jnp.asarray(idx[bi, kh]), bq=32, bk=32,
            causal=causal)
        assert_close(got[bi, h], oracle)
        mine = t_ref.block_attention_ref(
            tt(q[bi, h]), tt(k[bi, kh]), tt(v[bi, kh]), tt(kpos[bi, kh]),
            tt(qpos), tt(idx[bi, kh]), bq=32, bk=32, causal=causal)
        assert_close(mine, oracle)


def test_b6_uniform_weights_when_every_selected_key_is_future():
    """NEG_INF masking with an unmasked exp: a query row whose selected
    keys all lie in its future gets uniform weights in both packages."""
    q, k, v, kpos, qpos, idx = _tile_inputs(9, b=1, hq=2, hkv=1, s=64,
                                            bq=32, bk=32, n_sel=1)
    kpos = np.broadcast_to(np.arange(64, dtype=np.int32), (1, 1, 64)).copy()
    idx[...] = 1                              # keys 32..63 for every row
    args = (q, k, v, kpos, qpos, idx)
    got = t_ckv.sparse_block_attention(*map(tt, args), 32, 32)
    want = r_ckv.sparse_block_attention(*map(jnp.asarray, args), 32, 32)
    assert_close(got, want)
    np.testing.assert_allclose(tn(got)[0, 0, 0], v[0, 0, 32:].mean(0),
                               rtol=1e-5, atol=1e-5)


def _decode_inputs(seed, b=3, hkv=2, g=2, s=128, dh=16, bk=16, holes=False):
    rng = _rng(seed)
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    nkb = s // bk
    pos = np.empty((b, hkv, s), np.int32)
    for bi in range(b):
        for hi in range(hkv):
            pos[bi, hi] = (rng.permutation(nkb)[:, None] * bk
                           + np.arange(bk)).reshape(-1)
    if holes:
        pos[rng.random(pos.shape) < 0.25] = BIG
        pos[0, 0, :bk] = BIG                  # one whole hole tile
    cent = k.reshape(b, hkv, nkb, bk, dh).mean(3)
    return q, k, v, pos, cent


@pytest.mark.parametrize("n_sel", [1, 4, 8])
def test_decode_select_and_attend_match_reference(n_sel):
    q, k, v, pos, cent = _decode_inputs(10)
    idx = t_ckv.decode_select(tt(q), tt(cent), n_sel)
    ridx = r_ckv.decode_select(jnp.asarray(q), jnp.asarray(cent), n_sel)
    np.testing.assert_array_equal(tn(idx), np.asarray(ridx))
    for qpos in (5, 70, 127):
        got = t_ckv.decode_attend(tt(q), tt(k), tt(v), tt(pos), qpos, idx, 16)
        want = r_ckv.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(qpos, jnp.int32), ridx, 16)
        assert_close(got, want)


@pytest.mark.parametrize("g", [1, 3])
def test_b5_plain_mode_matches_reference_pair(g):
    q, k, v, pos, cent = _decode_inputs(11, g=g)
    for qpos in (3, 64, 127):
        got = t_ops.decode_attend_fused(tt(q), tt(k), tt(v), tt(pos),
                                        tt(cent), qpos, n_sel=4, bk=16)
        ridx = r_ckv.decode_select(jnp.asarray(q), jnp.asarray(cent), 4)
        want = r_ckv.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(qpos, jnp.int32), ridx, 16)
        assert_close(got, want)


@pytest.mark.parametrize("has_self", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_b5_plan_mode_matches_plan_decode_xla(has_self, g):
    q, k, v, pos, cent = _decode_inputs(12 + g, g=g, holes=True)
    pos[2][pos[2] == 0] = BIG                    # slot 2: nothing live yet
    rng = _rng(13)
    ks = rng.standard_normal((3, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((3, 2, 16)).astype(np.float32)
    qpos = np.array([30, 100, 0], np.int32)
    cfg = RCKV(enabled=True, block_k=16, decode_clusters=3,
               local_window_blocks=1)
    got = t_da.decode_attend_fused(
        tt(q), tt(k), tt(v), tt(pos), tt(cent), tt(qpos), tt(ks), tt(vs),
        n_sel=3, bk=16, plan_mode=True, has_self=has_self, window=16)
    want = r_attn._plan_decode_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(cent), jnp.asarray(qpos), cfg,
        k_self=jnp.asarray(ks) if has_self else None,
        v_self=jnp.asarray(vs) if has_self else None)
    assert_close(got, want)
    if not has_self:
        assert (tn(got)[2] == 0).all()            # guarded empty selection


@pytest.mark.parametrize("mode", ["plain", "plan"])
def test_b5_selects_a_nan_key_tile_like_the_reference(mode):
    """ROADMAP C15: a key tile holding NaN scores NaN. The reference
    (``lax.top_k``) and the port's plain path select it first, and the
    query rows of its kv head come out NaN in both; B5's rank rule
    (emulated over the kernel's scores and plan-mode masks) selects the
    same tiles in the same order. A NaN tile with no live entry stays
    masked at NEG_INF (plan mode)."""
    b, hkv, g, s, dh, bk, n_sel = 3, 2, 2, 128, 16, 16, 3
    plan = mode == "plan"
    q, k, v, pos, _ = _decode_inputs(80, holes=plan)
    nkb = s // bk
    k[1, 0, 3 * bk:4 * bk] = np.nan        # tile 3 of (member 1, head 0)
    k[0, 0, :bk, 0] = np.nan               # tile 0 of (0, 0): all holes
    cent = k.reshape(b, hkv, nkb, bk, dh).mean(3)
    qpos = np.array([127, 127, 60], np.int32)
    scores = tn((tt(q).reshape(b, hkv, g, dh).mean(2)[:, :, None, :]
                 * tt(cent)).sum(-1))
    if plan:
        pt = pos.reshape(b, hkv, nkb, bk)
        live = pt <= qpos[:, None, None, None]
        rec = np.where(live, pt, -1).max(-1)
        scores = np.where(rec < 0, np.float32(-1e30),
                          np.where(rec >= qpos[:, None, None] - bk,
                                   scores + np.float32(1e4), scores))
        port = tn(t_ckv.plan_select(tt(q), tt(pos), tt(cent), tt(qpos),
                                    n_sel=n_sel, bk=bk, window=bk))
        cfg = RCKV(enabled=True, block_k=bk, decode_clusters=n_sel,
                   local_window_blocks=1)
        want = r_attn._plan_decode_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(cent), jnp.asarray(qpos), cfg)
        assert port[0, 0, 0] != 0          # the masked NaN tile: not first
    else:
        port = tn(t_ckv.decode_select(tt(q), tt(cent), n_sel))
        ridx = r_ckv.decode_select(jnp.asarray(q), jnp.asarray(cent), n_sel)
        np.testing.assert_array_equal(port, np.asarray(ridx))
        qpos = np.int32(127)               # the reference's scalar qpos
        want = r_ckv.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(qpos), ridx, bk)
    assert port[1, 0, 0] == 3              # the live NaN tile: first
    np.testing.assert_array_equal(_b5_rank_select(scores, n_sel), port)
    got = tn(t_da.decode_attend_fused(
        tt(q), tt(k), tt(v), tt(pos), tt(cent), tt(qpos), n_sel=n_sel,
        bk=bk, plan_mode=plan, window=bk))
    assert np.isnan(got[1, :g]).all() and np.isfinite(got[1, g:]).all()
    assert_close(got, want)                # NaN where the reference is NaN


def test_b5_rejects_a_ragged_cache():
    q, k, v, pos, cent = _decode_inputs(14)
    with pytest.raises(ValueError, match="needs 9 whole 16-tiles"):
        t_da.decode_attend_fused(tt(q), tt(k), tt(v), tt(pos), tt(cent), 5,
                                 n_sel=9, bk=16)
    with pytest.raises(ValueError, match="whole 48-tiles"):
        t_da.decode_attend_fused(tt(q), tt(k), tt(v), tt(pos), tt(cent), 5,
                                 n_sel=2, bk=48)


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("self_dtype", [torch.float32, torch.bfloat16])
def test_b5_plan_mode_promotes_the_self_column_over_bf16_caches(self_dtype,
                                                               g):
    """ROADMAP C14: bf16 caches with a float32 self column. The reference's
    concatenate promotes the column to float32; the port's plain version
    and the kernel wrapper on a CPU tensor must not round it to bf16."""
    b, hkv, s, dh, bk, n_sel = 2, 2, 256, 16, 32, 3
    q, k, v, pos, cent = _decode_inputs(40 + g, b=b, hkv=hkv, g=g, s=s,
                                        dh=dh, bk=bk, holes=True)
    rng = _rng(41)
    ks = rng.standard_normal((b, hkv, dh)).astype(np.float32) * 3.0
    vs = rng.standard_normal((b, hkv, dh)).astype(np.float32) * 3.0
    k16, v16 = tt(k).to(torch.bfloat16), tt(v).to(torch.bfloat16)
    ks_t, vs_t = tt(ks).to(self_dtype), tt(vs).to(self_dtype)
    cent = tn(t_ckv.block_centroids(k16.float(), bk))
    qpos = np.array([200, 90], np.int32)
    cfg = RCKV(enabled=True, block_k=bk, decode_clusters=n_sel,
               local_window_blocks=1)
    jdt = jnp.float32 if self_dtype == torch.float32 else jnp.bfloat16
    want = r_attn._plan_decode_xla(
        jnp.asarray(q), jnp.asarray(tn(k16.float())).astype(jnp.bfloat16),
        jnp.asarray(tn(v16.float())).astype(jnp.bfloat16), jnp.asarray(pos),
        jnp.asarray(cent), jnp.asarray(qpos), cfg,
        k_self=jnp.asarray(tn(ks_t.float())).astype(jdt),
        v_self=jnp.asarray(tn(vs_t.float())).astype(jdt))
    kw = dict(n_sel=n_sel, bk=bk, window=bk)
    got = t_ckv.plan_decode_plain(tt(q), k16, v16, tt(pos), tt(cent),
                                  tt(qpos), k_self=ks_t, v_self=vs_t, **kw)
    assert_close(got, want)
    fused = t_da.decode_attend_fused(tt(q), k16, v16, tt(pos), tt(cent),
                                     tt(qpos), ks_t, vs_t, plan_mode=True,
                                     has_self=True, **kw)
    assert_close(fused, want)


# ---------------------------------------------------------------------------
# the arithmetic of the CUDA kernels, emulated on the CPU (nothing on the
# main path uses these emulations)
# ---------------------------------------------------------------------------


def _b6_emulation(q, k, v, kpos, qpos, idx, bq, bk, causal, split=True,
                  chunk=32):
    """B6's bf16 kernel in float32 PyTorch: logits in log2 units, an online
    softmax over chunks of ``chunk`` keys, and P.V as two bf16 terms
    (hi = bf16(p), lo = bf16(p - hi)) whose products are float32; with
    ``split=False`` p is rounded to bf16 once. Returns float32."""
    b, hq, s, dh = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g, nqb, n_sel = hq // hkv, s // bq, idx.shape[-1]
    scale_log2 = torch.tensor(1.4426950408889634 / dh ** 0.5)
    qb = q.reshape(b, hkv, g, nqb, bq, dh).float()
    kb = k.reshape(b, hkv, s_k // bk, bk, dh).float()
    vb = v.reshape(b, hkv, s_k // bk, bk, dh).float()
    pb = kpos.reshape(b, hkv, s_k // bk, bk)
    qp = qpos.reshape(nqb, bq)
    bi = torch.arange(b)[:, None, None]
    hi_ = torch.arange(hkv)[None, :, None]
    m = torch.full((b, hkv, g, nqb, bq), t_ckv.NEG_INF)
    l = torch.zeros((b, hkv, g, nqb, bq))
    acc = torch.zeros((b, hkv, g, nqb, bq, dh))
    for j in range(n_sel):
        t = idx[..., j].long()
        for c0 in range(0, bk, chunk):
            kt = kb[bi, hi_, t][..., c0:c0 + chunk, :]
            vt = vb[bi, hi_, t][..., c0:c0 + chunk, :]
            pt = pb[bi, hi_, t][..., c0:c0 + chunk]
            x = torch.einsum("bhgqtd,bhqsd->bhgqts", qb, kt) * scale_log2
            if causal:
                ok = pt[:, :, None, :, None, :] <= qp[None, None, None, :, :,
                                                      None]
                x = torch.where(ok, x, t_ckv.NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            terms = [hi, (p - hi).to(torch.bfloat16).float()] if split \
                else [hi]
            acc = acc * alpha[..., None] + sum(
                torch.einsum("bhgqts,bhqsd->bhgqtd", w, vt) for w in terms)
            m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, s, dh)


def _c10_bound(want):
    """2e-5 x max|want| plus one bf16 spacing at each element's magnitude
    (ROADMAP C10)."""
    _, e = torch.frexp(want)
    return 2e-5 * float(want.abs().max()) + torch.where(
        want == 0, 0.0, torch.ldexp(torch.ones_like(want), e - 8))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq", [64, 128])
def test_b6_hi_lo_split_stays_within_the_c10_bound(bq, causal):
    """Phase 2's B6 shapes (S = 2048, 14 query / 2 kv heads, n_sel = 8,
    bf16): the hi/lo split of P keeps the kernel's arithmetic within the
    C10 bound of the plain version, where rounding p to bf16 once does not,
    and its float32 error is far below that of the single rounding."""
    s, n_sel = 2048, 8
    q, k, v, kpos, qpos, idx = _tile_inputs(50 + bq + causal, b=1, hq=14,
                                            hkv=2, s=s, dh=64, bq=bq, bk=bq,
                                            n_sel=n_sel)
    q16, k16, v16 = (tt(a).to(torch.bfloat16) for a in (q, k, v))
    args = (q16, k16, v16, tt(kpos), tt(qpos), tt(idx))
    want = t_ba.block_attention_plain(*args, bq=bq, bk=bq, causal=causal)
    got = _b6_emulation(*args, bq, bq, causal)
    bound = _c10_bound(want.float())
    assert bool(((got.to(torch.bfloat16).float() - want.float()).abs()
                 <= bound).all())
    # p rounded to bf16 once would not be (the reason for the split)
    once = _b6_emulation(*args, bq, bq, causal, split=False)
    assert not bool(((once.to(torch.bfloat16).float() - want.float()).abs()
                     <= bound).all())
    # in float32, before the output's rounding: hi/lo against one rounding
    exact = t_ckv.sparse_block_attention(q16.float(), k16.float(),
                                         v16.float(), *args[3:], bq, bq,
                                         causal=causal)
    err_split = float((got - exact).abs().max())
    err_once = float((once - exact).abs().max())
    assert err_split <= 2e-5 * float(exact.abs().max())
    assert err_once > 10 * err_split


def _b5_partition_emulation(q, k, v, pos, cent, qpos, k_self, v_self, *,
                            n_sel, bk, plan_mode, has_self, window):
    """B5's split in float32 PyTorch: the selection, one partial softmax
    (max m_i over the part's columns, masked at -1e30; live sum l_i;
    accumulator acc_i) per selected tile and for the self column, then
    the fixed-order combine M = max m_i, L = sum l_i e^(m_i - M),
    out = sum acc_i e^(m_i - M) / max(L, 1e-30)."""
    b, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qp = torch.as_tensor(qpos).to(torch.int64).reshape(-1).expand(b)
    if plan_mode:
        sel = t_ckv.plan_select(q, pos, cent, qp, n_sel=n_sel, bk=bk,
                                window=window)
    else:
        sel = t_ckv.decode_select(q.float(), cent.float(), n_sel).long()
    qh = q.reshape(b, hkv, g, dh).float()
    parts = []
    for j in range(n_sel):
        kt = t_ckv.gather_tiles(k, sel[..., j:j + 1], bk).float()
        vt = t_ckv.gather_tiles(v, sel[..., j:j + 1], bk).float()
        pt = t_ckv.gather_tiles(pos, sel[..., j:j + 1], bk).to(torch.int64)
        parts.append((kt, vt, pt))
    if plan_mode and has_self:
        parts.append((k_self[:, :, None].float(), v_self[:, :, None].float(),
                      qp[:, None, None].expand(b, hkv, 1)))
    ms, ls, accs = [], [], []
    for kt, vt, pt in parts:
        live = (pt <= qp[:, None, None])[:, :, None, :]        # (b,hkv,1,c)
        x = torch.where(live, t_ckv.decode_logits(qh, kt), t_ckv.NEG_INF)
        m_i = x.amax(-1)
        p = torch.where(live, torch.exp(x - m_i[..., None]), 0.0)
        ms.append(m_i)
        ls.append(p.sum(-1))
        accs.append(p @ vt)
    big_m = torch.stack(ms).amax(0)
    total_l = torch.zeros_like(big_m)
    out = torch.zeros_like(accs[0])
    for m_i, l_i, acc_i in zip(ms, ls, accs):
        w = torch.exp(m_i - big_m)
        total_l = total_l + l_i * w
        out = out + acc_i * w[..., None]
    out = out / torch.clamp_min(total_l, 1e-30)[..., None]
    return out.reshape(b, hq, -1).to(q.dtype)


@pytest.mark.parametrize("mode", ["plain", "plan", "plan_self"])
@pytest.mark.parametrize("n_sel", [1, 6, 16])
def test_b5_partials_and_fixed_order_combine_equal_the_plain_version(n_sel,
                                                                     mode):
    """B5's partition into per-tile partials and their combine equals the
    plain version: plain and plan mode, the self column, 20 % holes, and a
    slot whose every entry is a hole (exact zeros without the self
    column)."""
    b, hkv, g, s, dh, bk = 3, 2, 3, 256, 16, 16
    plan_mode, has_self = mode != "plain", mode == "plan_self"
    rng = _rng(60 + n_sel)
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    nkb = s // bk
    pos = np.stack([np.stack([(rng.permutation(nkb)[:, None] * bk
                               + np.arange(bk)).reshape(-1)
                              for _ in range(hkv)]) for _ in range(b)])
    if plan_mode:
        pos[rng.random(pos.shape) < 0.2] = BIG
    pos[2] = BIG                                     # slot 2: only holes
    pos = pos.astype(np.int32)
    cent = k.reshape(b, hkv, nkb, bk, dh).mean(3)
    ks = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    vs = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    qpos = np.array([200, 77, 150], np.int32)
    args = tuple(map(tt, (q, k, v, pos, cent, qpos, ks, vs)))
    kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode, has_self=has_self,
              window=bk)
    got = _b5_partition_emulation(*args, **kw)
    want = t_da.decode_attend_plain(*args, **kw)
    assert_close(got, want)
    if has_self:
        assert_close(got[2], np.repeat(vs[2], g, axis=0))
    else:
        assert (tn(got)[2] == 0).all() and (tn(want)[2] == 0).all()
