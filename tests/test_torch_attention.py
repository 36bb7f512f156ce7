"""Attention backends (``models/attention.py``) and the decode-backend
registry against the reference, on the same numpy inputs (float32,
``rtol 1e-5``).

ClusterKV orderings of the two packages agree on these inputs (the
deterministic PCA start and LAPACK's QR on both sides); where a test needs
the reference's ordering regardless, it injects it through the tensor form
of ``plan_batch`` (ROADMAP C4 discipline).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, plan_from_reference, tn, tt

from repro.configs.base import ClusterKVConfig as RCKV
from repro.core import clusterkv as r_ckv
from repro.core import registry as r_reg
from repro.models import attention as r_attn
from repro_torch.configs.base import ClusterKVConfig as TCKV
from repro_torch.core import clusterkv as t_ckv
from repro_torch.core import registry as t_reg
from repro_torch.kernels import decode_attend as t_da
from repro_torch.kernels import ops as t_ops
from repro_torch.models import attention as t_attn

BIG = 2 ** 31 - 1


def _qkv(seed, b=2, hq=4, hkv=2, s=128, dh=16, clustered=True):
    rng = np.random.default_rng(seed)
    if clustered:
        cc = rng.standard_normal((4, dh)) * 3.0
        k = (cc[rng.integers(0, 4, (b, hkv, s))]
             + 0.3 * rng.standard_normal((b, hkv, s, dh)))
        q = np.repeat(k, hq // hkv, axis=1) \
            + 0.1 * rng.standard_normal((b, hq, s, dh))
    else:
        k = rng.standard_normal((b, hkv, s, dh))
        q = rng.standard_normal((b, hq, s, dh))
    v = rng.standard_normal((b, hkv, s, dh))
    return (q.astype(np.float32), k.astype(np.float32),
            v.astype(np.float32))


def _cfgs(**kw):
    return RCKV(enabled=True, **kw), TCKV(enabled=True, **kw)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    assert_close(t_attn.rope(tt(x), tt(pos), theta),
                 r_attn.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_dense_and_flash_attention_match_reference(causal, window):
    q, k, v = _qkv(1, s=96)
    pos = np.arange(96, dtype=np.int32)
    args_t = (tt(q), tt(k), tt(v), tt(pos), tt(pos))
    args_r = tuple(map(jnp.asarray, (q, k, v, pos, pos)))
    want = r_attn.dense_attention(*args_r, causal=causal, window=window)
    assert_close(t_attn.dense_attention(*args_t, causal=causal,
                                        window=window), want)
    for block in (32, 40):                     # 40: a padded last tile
        assert_close(t_attn.flash_attention(*args_t, causal=causal,
                                            window=window, block=block),
                     r_attn.flash_attention(*args_r, causal=causal,
                                            window=window, block=block))


@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_matches_reference(window):
    q, k, v = _qkv(2, s=64)
    q1 = q[:, :, 0]
    kpos = np.arange(64, dtype=np.int32)
    for qpos in (5, np.array([10, 63], np.int32)[:, None, None, None]):
        assert_close(
            t_attn.decode_attention(tt(q1), tt(k), tt(v), tt(kpos),
                                    qpos if np.isscalar(qpos) else tt(qpos),
                                    window=window),
            r_attn.decode_attention(jnp.asarray(q1), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(kpos),
                                    jnp.asarray(qpos), window=window))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_sel", [2, 8])
def test_clusterkv_attention_matches_reference(causal, n_sel):
    q, k, v = _qkv(3, s=256)
    pos = np.arange(256, dtype=np.int32)
    rc, tc = _cfgs(block_q=32, block_k=32, blocks_per_query=n_sel,
                   embed_dim=2)
    got = t_attn.clusterkv_attention(tt(q), tt(k), tt(v), tt(pos), tt(pos),
                                     tc, causal=causal)
    want = r_attn.clusterkv_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                      rc, causal=causal)
    assert_close(got, want)


@pytest.mark.parametrize("form", ["tensor", "plan_batch"])
def test_clusterkv_attention_with_injected_orderings(form):
    """``plan_batch`` as the reference's own ordering tensor, or as a port
    ``PlanBatch`` stacked from the reference's members: either way the
    selection and output equal the reference's."""
    q, k, v = _qkv(4, b=1, s=128, clustered=False)
    pos = np.arange(128, dtype=np.int32)
    rc, tc = _cfgs(block_q=32, block_k=32, blocks_per_query=2)
    rpb = r_ckv.kv_plan_batch(jnp.asarray(k))
    want = r_attn.clusterkv_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                      rc, plan_batch=rpb)
    perm = np.asarray(r_ckv.plan_batch_perm(rpb, (1, 2)))
    if form == "tensor":
        pb = tt(perm)
    else:
        from repro_torch import api as t_api
        pb = t_api.PlanBatch.from_plans([plan_from_reference(p)
                                         for p in rpb.members()])
    got = t_attn.clusterkv_attention(tt(q), tt(k), tt(v), tt(pos), tt(pos),
                                     tc, plan_batch=pb)
    assert_close(got, want)


def test_clusterkv_attention_never_attends_holes():
    """Key slots at INT32_MAX (capacity holes) carry no weight: garbage in
    their values leaves the output unchanged."""
    q, k, v = _qkv(5, b=1, s=128)
    pos = np.arange(128, dtype=np.int32)
    kpos = np.broadcast_to(pos, (1, 2, 128)).copy()
    holes = np.random.default_rng(5).random((1, 2, 128)) < 0.2
    kpos[holes] = BIG
    v2 = v.copy()
    v2[holes] = 1e6
    _, tc = _cfgs(block_q=32, block_k=32, blocks_per_query=4)
    perm = tt(np.argsort(np.random.default_rng(6).random((1, 2, 128)), -1))
    a = t_attn.clusterkv_attention(tt(q), tt(k), tt(v), tt(pos), tt(kpos),
                                   tc, plan_batch=perm)
    b = t_attn.clusterkv_attention(tt(q), tt(k), tt(v2), tt(pos), tt(kpos),
                                   tc, plan_batch=perm)
    assert_close(a, b)


@pytest.mark.parametrize("use_kernel", [False, True, "auto"])
def test_clusterkv_decode_matches_reference(use_kernel):
    q, k, v = _qkv(7, s=128)
    q1 = q[:, :, 5]
    kpos = np.arange(128, dtype=np.int32)
    rc = RCKV(enabled=True, block_k=32, decode_clusters=2)
    tc = TCKV(enabled=True, block_k=32, decode_clusters=2,
              use_kernel=use_kernel)
    for qpos in (40, 127):
        got = t_attn.clusterkv_decode(tt(q1), tt(k), tt(v), tt(kpos), qpos,
                                      tc)
        want = r_attn.clusterkv_decode(jnp.asarray(q1), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(kpos),
                                       jnp.asarray(qpos, jnp.int32), rc)
        assert_close(got, want)


def test_clusterkv_decode_ragged_cache_falls_back_to_dense():
    q, k, v = _qkv(8, s=100)
    q1 = q[:, :, 0]
    kpos = np.arange(100, dtype=np.int32)
    rc, tc = _cfgs(block_k=32, decode_clusters=2)
    got = t_attn.clusterkv_decode(tt(q1), tt(k), tt(v), tt(kpos), 70, tc)
    assert_close(got, r_attn.decode_attention(
        jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
        jnp.asarray(70, jnp.int32)))
    assert_close(got, r_attn.clusterkv_decode(
        jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
        jnp.asarray(70, jnp.int32), rc))


def _plan_caches(seed, b=3, hkv=2, s=128, dh=16, bk=32):
    q, k, v = _qkv(seed, b=b, s=s)
    rng = np.random.default_rng(seed)
    nkb = s // bk
    ps = np.stack([np.stack([(rng.permutation(nkb)[:, None] * bk
                              + np.arange(bk)).reshape(-1)
                             for _ in range(hkv)]) for _ in range(b)])
    ps[rng.random(ps.shape) < 0.2] = BIG
    ps = ps.astype(np.int32)
    cent = k.reshape(b, hkv, nkb, bk, dh).mean(3)
    return q[:, :, 0], k, v, ps, cent


@pytest.mark.parametrize("backend", ["plain", "cuda", "auto"])
@pytest.mark.parametrize("with_self", [False, True])
def test_clusterkv_plan_decode_matches_xla_backend(backend, with_self):
    q1, ks, vs, ps, cent = _plan_caches(9)
    rng = np.random.default_rng(10)
    ksf = rng.standard_normal((3, 2, 16)).astype(np.float32)
    vsf = rng.standard_normal((3, 2, 16)).astype(np.float32)
    qpos = np.array([20, 127, 64], np.int32)
    rc = RCKV(enabled=True, block_k=32, decode_clusters=2,
              decode_backend="xla")
    tc = TCKV(enabled=True, block_k=32, decode_clusters=2,
              decode_backend=backend)
    assert t_attn.resolve_decode_backend(tc, tt(q1)) in ("plain", "cuda")
    n0 = t_da.decode_attend_fused.launches
    got = t_attn.clusterkv_plan_decode(
        tt(q1), tt(ks), tt(vs), tt(ps), tt(cent), tt(qpos), tc,
        k_self=tt(ksf) if with_self else None,
        v_self=tt(vsf) if with_self else None)
    assert t_da.decode_attend_fused.launches == n0      # CPU: no launch
    want = r_attn.clusterkv_plan_decode(
        *map(jnp.asarray, (q1, ks, vs, ps, cent, qpos)), rc,
        k_self=jnp.asarray(ksf) if with_self else None,
        v_self=jnp.asarray(vsf) if with_self else None)
    assert_close(got, want)


def _ref_plan_select(q1, ps, cent, qpos, n_sel, bk, window):
    """The reference's plan-mode selection, restated line for line from
    ``_plan_decode_xla`` (which returns no indices): the group mean is taken
    in q's dtype, then cast to float32."""
    import jax
    b, hq, dh = q1.shape
    hkv, s = ps.shape[1], ps.shape[2]
    pt = jnp.asarray(ps).reshape(b, hkv, s // bk, bk)
    qp = jnp.asarray(qpos)
    live = pt <= qp[:, None, None, None]
    has = live.any(-1)
    qg = q1.reshape(b, hkv, hq // hkv, dh).mean(axis=2).astype(jnp.float32)
    sc = jnp.sum(qg[:, :, None, :] * jnp.asarray(cent, jnp.float32), -1)
    sc = jnp.where(has, sc, -1e30)
    near = jnp.where(live, pt, -1).max(-1) >= qp[:, None, None] - window
    sc = jnp.where(near & has, sc + 1e4, sc)
    return np.asarray(jax.lax.top_k(sc, n_sel)[1])


def test_plan_select_matches_the_xla_backends_top_k():
    q1, ks, vs, ps, cent = _plan_caches(11, b=4)
    qpos = np.array([3, 127, 64, 90], np.int32)
    got = t_ckv.plan_select(tt(q1), tt(ps), tt(cent), tt(qpos), n_sel=3,
                            bk=32, window=32)
    np.testing.assert_array_equal(
        tn(got), _ref_plan_select(jnp.asarray(q1), ps, cent, qpos, 3, 32, 32))


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_plan_select_bf16_takes_the_float32_group_mean(seed):
    """ROADMAP C13: in bf16 the port averages the query group in float32,
    as both fused kernels do; its selection equals the reference's
    arithmetic on the same bf16 values with a float32 mean."""
    q1, ks, vs, ps, cent = _plan_caches(seed, b=4, hkv=2, s=256)
    q16 = torch.from_numpy(q1).to(torch.bfloat16)
    q32 = jnp.asarray(q16.float().numpy())            # bf16 values, f32 dtype
    qpos = np.array([255, 100, 180, 40], np.int32)
    got = t_ckv.plan_select(q16, tt(ps), tt(cent), tt(qpos), n_sel=3, bk=32,
                            window=32)
    np.testing.assert_array_equal(
        tn(got), _ref_plan_select(q32, ps, cent, qpos, 3, 32, 32))


def test_plan_select_bf16_differs_from_the_xla_bf16_mean():
    """ROADMAP C13, the documented difference: two bf16 query rows 1.0 and
    1 + 2^-7 average to 1 + 2^-8 in float32 but round to 1.0 in bf16, which
    flips the order of two tiles. The reference's XLA path (bf16 mean)
    picks tile 1, the port and the reference on float32 values tile 0."""
    q = np.array([[[1.0, 1.0], [1.0 + 2 ** -7, 1.0]]], np.float32)  # g = 2
    cent = np.array([[[[1.0, 0.0], [0.0, 1.002]]]], np.float32)
    ks = np.zeros((1, 1, 4, 2), np.float32)
    vs = np.repeat(np.array([1.0, -1.0], np.float32), 2)[None, None, :,
                                                         None].repeat(2, -1)
    ps = np.arange(4, dtype=np.int32)[None, None]
    qpos = np.array([100], np.int32)                 # no tile is "recent"
    rc = RCKV(enabled=True, block_k=2, decode_clusters=1,
              local_window_blocks=0)
    args = tuple(map(jnp.asarray, (ks, vs, ps, cent, qpos)))
    ref_bf16 = r_attn._plan_decode_xla(jnp.asarray(q, jnp.bfloat16), *args,
                                       rc)
    ref_f32 = r_attn._plan_decode_xla(jnp.asarray(q), *args, rc)
    q16 = tt(q).to(torch.bfloat16)
    assert tn(t_ckv.plan_select(q16, tt(ps), tt(cent), tt(qpos), n_sel=1,
                                bk=2, window=0)).ravel().tolist() == [0]
    got = t_ckv.plan_decode_plain(q16, tt(ks), tt(vs), tt(ps), tt(cent),
                                  tt(qpos), n_sel=1, bk=2, window=0)
    np.testing.assert_array_equal(tn(got.float()), np.ones((1, 2, 2)))
    np.testing.assert_array_equal(np.asarray(ref_f32), np.ones((1, 2, 2)))
    np.testing.assert_array_equal(np.asarray(ref_bf16, np.float32),
                                  -np.ones((1, 2, 2)))


@pytest.mark.parametrize("qpos", [[60, 127], [127, 127]])
def test_clusterkv_percall_decode_matches_reference(qpos):
    q, k, v = _qkv(12, s=128)
    q1 = q[:, :, 0]
    kpos = np.arange(128, dtype=np.int32)
    rc, tc = _cfgs(block_k=32, decode_clusters=2, embed_dim=3)
    qp = np.array(qpos, np.int32)
    got = t_attn.clusterkv_percall_decode(tt(q1), tt(k), tt(v), tt(kpos),
                                          tt(qp), tc)
    want = r_attn.clusterkv_percall_decode(
        *map(jnp.asarray, (q1, k, v, kpos, qp)), rc)
    assert_close(got, want)


def test_decode_backend_registry():
    assert t_reg.decode_backend_names() == ("cuda", "plain")
    assert set(r_reg.decode_backend_names()) == {"xla", "pallas"}
    assert t_reg.get_decode_backend("cuda") is t_ops._cuda_plan_decode
    with pytest.raises(ValueError, match="did you mean 'plain'"):
        t_reg.get_decode_backend("plane")
    with pytest.raises(ValueError, match="already registered"):
        t_reg.register_decode_backend("plain", lambda *a, **k: None)
    fn = t_reg.get_decode_backend("plain")
    assert t_reg.register_decode_backend("plain", fn) is fn   # same: no-op


def test_config_renames_and_auto_resolution():
    with pytest.raises(ValueError, match="use_kernel"):
        TCKV(use_kernel="sometimes")
    x = torch.zeros(1)
    assert t_attn.resolve_decode_backend(TCKV(), x) == "plain"
    assert t_attn.resolve_decode_backend(TCKV(decode_backend="cuda"), x) \
        == "cuda"
    for setting in (False, True, "auto"):     # CPU: every setting is plain
        t_attn._check_kernel_setting(TCKV(use_kernel=setting), x)
