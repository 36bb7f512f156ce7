"""The mamba blocks, the SSM LM (falcon-mamba) and the Zamba2 hybrid
(ROADMAP A13b) against the reference.

The same numpy inputs (or the reference's float32 parameters crossed over
by ``convert.params_from_reference``) go through both packages on the CPU.
Tolerances:

* the causal conv and the single decode steps: ``rtol 1e-5`` (the same
  float32 arithmetic, summed in another order);
* ``selective_scan`` and ``ssd``: ``rtol 1e-5`` with ``atol 1e-5 x
  max|y|``: the port scans a chunk in ``log2(chunk)`` doubling steps
  (Hillis-Steele) and contracts the SSD einsums pairwise, so the float32
  products are associated in another order than XLA's
  ``associative_scan`` and four-operand einsums;
* whole models: logits of ``prefill`` and each ``decode_step`` within
  ``1e-4 x max|logits|``, caches within ``1e-4``, as the A13a zoo
  (``tests/test_torch_models.py``);
* teacher forcing (``prefill(S)`` against ``prefill(S-1)`` + one step),
  as the reference's ``tests/test_models.py``: ``2e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt

from repro.configs import base as r_base
from repro.configs.base import ClusterKVConfig as RCKV
from repro.models import hybrid as r_hy
from repro.models import mamba as r_mb
from repro.models import model_api as r_api
from repro.models import sharding as r_shd
from repro.models import ssm_lm as r_ssm
from repro.models.sharding import NO_SHARD
from repro_torch import convert as t_convert
from repro_torch.configs import base as t_base
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import hybrid as t_hy
from repro_torch.models import mamba as t_mb
from repro_torch.models import model_api as t_api
from repro_torch.models import param as t_pm
from repro_torch.models import sharding as t_shd
from repro_torch.models import ssm_lm as t_ssm

SEQ, CACHE, STEPS = 64, 128, 3
LOGIT_TOL = 1e-4
SCAN_TOL = 1e-5


def _cfg(arch, **ckv):
    kw = dict(enabled=True, block_q=16, block_k=16, blocks_per_query=2,
              decode_clusters=2)
    kw.update(ckv)
    return r_base.reduced_config(arch).with_(dtype="float32",
                                             clusterkv=RCKV(**kw))


def _cross(rcfg, seed=0):
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(seed))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    return rp, tcfg, tp


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
def ssm_model(request):
    rcfg = _cfg(request.param)
    return (request.param, rcfg) + _cross(rcfg, seed=1)


def _tokens(cfg, seed, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _close_logits(port, ref, tol=LOGIT_TOL):
    ref = tn(ref)
    np.testing.assert_allclose(tn(port), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _close_scaled(port, ref):
    ref = tn(ref)
    np.testing.assert_allclose(tn(port), ref, rtol=SCAN_TOL,
                               atol=SCAN_TOL * float(np.abs(ref).max()))


def _mod(cfg):
    return (r_ssm, t_ssm) if cfg.family == "ssm" else (r_hy, t_hy)


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------


def test_conv1d_apply_and_step_match_the_reference():
    """The causal depthwise conv over a sequence, and step by step from a
    zero history: the (width, 1, C) weight crosses over unchanged."""
    rp, _ = r_mb.conv1d_init(jax.random.PRNGKey(0), 6, 4)
    rp = dict(rp, b=jnp.asarray(np.random.default_rng(1).standard_normal(
        6).astype(np.float32)))
    tp = t_pm.tree_map(tt, jax.tree.map(np.asarray, rp))
    assert tuple(tp["w"].shape) == (4, 1, 6)
    x = np.random.default_rng(2).standard_normal((2, 11, 6)).astype(
        np.float32)
    want = r_mb.conv1d_apply(rp, jnp.asarray(x))
    got = t_mb.conv1d_apply(tp, torch.from_numpy(x))
    assert_close(got, want)
    rbuf = jnp.zeros((2, 3, 6), jnp.float32)
    tbuf = torch.zeros((2, 3, 6))
    for t in range(x.shape[1]):
        rbuf, ry = r_mb.conv1d_step(rp, rbuf, jnp.asarray(x[:, t:t + 1]))
        tbuf, ty = t_mb.conv1d_step(tp, tbuf, torch.from_numpy(
            x[:, t:t + 1]))
        assert_close(ty, ry)
        assert_close(ty[:, 0], got[:, t])
        assert_close(tbuf, rbuf)


def _scan_inputs(seed, b, s, di, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, di)).astype(np.float32),
            (0.1 + rng.random((b, s, di))).astype(np.float32),
            -np.exp(rng.standard_normal((di, n))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


def _naive_mamba1(xc, dt, a_mat, bc, cc):
    """The step recurrence in float64 (the reference test's ground truth)."""
    xc, dt, a_mat, bc, cc = (np.asarray(a, np.float64)
                             for a in (xc, dt, a_mat, bc, cc))
    h = np.zeros((xc.shape[0], xc.shape[2], a_mat.shape[-1]))
    ys = []
    for t in range(xc.shape[1]):
        h = np.exp(dt[:, t, :, None] * a_mat) * h \
            + dt[:, t, :, None] * bc[:, t, None, :] * xc[:, t, :, None]
        ys.append(np.einsum("bdn,bn->bd", h, cc[:, t]))
    return np.stack(ys, 1), h


# (S, chunk): one chunk, chunks that divide S, and S not a multiple of the
# chunk (the padded last chunk), as the reference's tests draw them
SCAN_CASES = [(16, 16), (32, 8), (21, 8), (5, 16), (40, 16), (3, 4)]


@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_selective_scan_matches_the_reference(s, chunk):
    args = _scan_inputs(s * 100 + chunk, 2, s, 6, 4)
    ry, rh = r_mb.selective_scan(*(jnp.asarray(a) for a in args), chunk)
    ty, th = t_mb.selective_scan(*(torch.from_numpy(a) for a in args), chunk)
    assert tuple(ty.shape) == (2, s, 6) and tuple(th.shape) == (2, 6, 4)
    _close_scaled(ty, ry)
    _close_scaled(th, rh)
    wy, wh = _naive_mamba1(*args)
    np.testing.assert_allclose(tn(ty), wy, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tn(th), wh, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_ssd_matches_the_reference(s, chunk):
    rng = np.random.default_rng(s * 100 + chunk + 7)
    b, h, p, n = 2, 3, 4, 5
    args = (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (0.1 + rng.random((b, s, h))).astype(np.float32),
            -np.exp(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))
    ry, rh = r_mb.ssd(*(jnp.asarray(a) for a in args), chunk)
    ty, th = t_mb.ssd(*(torch.from_numpy(a) for a in args), chunk)
    assert tuple(ty.shape) == (b, s, h, p) and tuple(th.shape) == (b, h, p, n)
    _close_scaled(ty, ry)
    _close_scaled(th, rh)


def test_segsum_masks_above_the_diagonal_with_minus_inf():
    a = torch.tensor([[0.5, -1.0, 2.0, 0.25]])
    want = r_mb._segsum(jnp.asarray(tn(a)))
    got = t_mb._segsum(a)
    np.testing.assert_array_equal(tn(got), np.asarray(want))
    assert torch.isneginf(got[0, 0, 1]) and not torch.isnan(got).any()


def _layer(rp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], rp["layers"]["mixer"]),
            t_pm.layer(tp["layers"], i)["mixer"])


@pytest.mark.parametrize("chunk", [16, 24])
def test_mamba_block_forward_and_steps_match_the_reference(ssm_model,
                                                           chunk):
    """One block: ``mamba{1,2}_forward`` over 40 tokens (chunk 24 pads the
    last chunk), its final state and conv buffers, then 3 single steps
    from that state, each against the reference's."""
    arch, rcfg, rp, tcfg, tp = ssm_model
    rcfg = rcfg.with_(ssm=dataclasses.replace(rcfg.ssm, chunk=chunk))
    tcfg = tcfg.with_(ssm=dataclasses.replace(tcfg.ssm, chunk=chunk))
    lr, lt = _layer(rp, tp)
    x = np.random.default_rng(3).standard_normal(
        (2, 40, rcfg.d_model)).astype(np.float32)
    v1 = rcfg.ssm.version == 1
    rf = r_mb.mamba1_forward if v1 else r_mb.mamba2_forward
    tf = t_mb.mamba1_forward if v1 else t_mb.mamba2_forward
    want = rf(lr, jnp.asarray(x), rcfg, NO_SHARD)
    got = tf(lt, torch.from_numpy(x), tcfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_scaled(g, w)
    rstate, tstate = list(want[1:]), [t.float() for t in got[1:]]
    rs = r_mb.mamba1_step if v1 else r_mb.mamba2_step
    ts = t_mb.mamba1_step if v1 else t_mb.mamba2_step
    x1 = np.random.default_rng(4).standard_normal(
        (3, 2, 1, rcfg.d_model)).astype(np.float32)
    for t in range(3):
        rout = rs(lr, jnp.asarray(x1[t]), *[jnp.asarray(a, jnp.float32)
                                            for a in rstate], rcfg)
        tout = ts(lt, torch.from_numpy(x1[t]), *tstate, tcfg)
        for g, w in zip(tout, rout):
            _close_scaled(g, w)
        rstate, tstate = list(rout[1:]), list(tout[1:])


def test_init_leaves_that_are_constants_match_the_reference():
    """``A_log``, ``D`` and ``dt_bias`` are constants, not draws: ``D`` and
    ``dt_bias`` exactly; ``A_log`` (``log(1..N)`` for mamba1,
    ``log(linspace(1, 16, nh))`` for mamba2) is the float64 value rounded
    once to float32, which lies within 3 float32 ulp of XLA's float32
    ``linspace`` and ``log`` (ROADMAP C39). For the reduced configs and
    the full ones' SSM widths: zamba2-1.2b whole (64 heads), falcon-mamba
    at d_model 64 (its constants depend on d_state = 16 alone, and its
    full-width block would draw 100 M weights for nothing)."""
    keys = ("A_log", "D", "dt_bias")
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        full = r_base.get_config(arch)
        if arch == "falcon-mamba-7b":
            full = full.with_(d_model=64)
        for rcfg in (r_base.reduced_config(arch), full):
            tcfg = t_convert.config_from_reference(rcfg)
            v1 = rcfg.ssm.version == 1
            rp, _ = (r_mb.init_mamba1 if v1 else r_mb.init_mamba2)(
                jax.random.PRNGKey(0), rcfg)
            tree = (t_mb.init_mamba1 if v1 else t_mb.init_mamba2)(tcfg)
            tp = t_pm.materialize({k: tree[k] for k in keys if k in tree},
                                  torch.Generator(), torch.device("cpu"))
            assert sorted(tp) == sorted(k for k in keys if k in rp)
            for key in ("D", "dt_bias"):
                if key in rp:
                    np.testing.assert_array_equal(tn(tp[key]),
                                                  np.asarray(rp[key]))
            assert tuple(tp["A_log"].shape) == rp["A_log"].shape
            np.testing.assert_array_max_ulp(tn(tp["A_log"]),
                                            np.asarray(rp["A_log"]),
                                            maxulp=3)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def test_configs_cells_and_params_match_the_reference(ssm_model):
    arch, rcfg, rp, tcfg, tp = ssm_model
    for ref, ours in ((r_base.get_config(arch), t_base.get_config(arch)),
                      (r_base.reduced_config(arch),
                       t_base.reduced_config(arch))):
        assert t_convert.config_from_reference(ref) == ours
    assert list(t_base.cells(arch)) == list(r_base.cells(arch))
    assert t_api.module_for(tcfg) is _mod(tcfg)[1]
    assert sum(x.size for x in jax.tree.leaves(rp)) == sum(
        t.numel() for t in t_pm.tree_leaves(tp))
    own = t_api.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert t_pm.tree_map(lambda t: tuple(t.shape), own) == \
        t_pm.tree_map(lambda t: tuple(t.shape), tp)


def test_forward_matches_the_reference(ssm_model):
    arch, rcfg, rp, tcfg, tp = ssm_model
    rmod, tmod = _mod(rcfg)
    tok = _tokens(rcfg, 5)
    rh, _ = rmod.forward(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                         "flash")
    th, aux = tmod.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                           "flash")
    assert_close(th, rh, atol=1e-4)
    assert float(aux) == 0.0


def _assert_caches_close(tc, rc, atol=1e-4):
    assert sorted(tc) == sorted(rc)
    for key in rc:
        if isinstance(rc[key], dict):
            _assert_caches_close(tc[key], rc[key], atol)
        elif key == "pos":
            assert int(tc[key]) == int(rc[key])
        else:
            assert tuple(tc[key].shape) == rc[key].shape
            assert tc[key].dtype == t_pm.DTYPES[str(rc[key].dtype)]
            assert_close(tc[key], rc[key], atol=atol)


@pytest.mark.parametrize("backend", ["flash", "dense", "clusterkv"])
def test_prefill_then_decode_matches_the_reference(ssm_model, backend):
    """``prefill`` of a 64-token batch (the cache leaf for leaf and the
    logits), then 3 ``decode_step``s in a cache grown to 128. The hybrid's
    shared block runs each backend (ClusterKV on: B6's and B5's plain
    versions); the SSM LM has no attention, so every backend is one
    path."""
    arch, rcfg, rp, tcfg, tp = ssm_model
    rmod, tmod = _mod(rcfg)
    tok = _tokens(rcfg, 6)
    rc, rl = rmod.prefill(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                          backend)
    tc, tl = tmod.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                          backend)
    _close_logits(tl, rl)
    _assert_caches_close(tc, rc)
    rc, tc = r_api.grow_cache(rcfg, rc, CACHE), t_api.grow_cache(tcfg, tc,
                                                                 CACHE)
    _assert_caches_close(tc, rc)
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(STEPS):
        rl, rc = rmod.decode_step(rp, rcfg, rc, jnp.asarray(nxt), NO_SHARD,
                                  backend)
        tl, tc = tmod.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                  backend)
        _close_logits(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    _assert_caches_close(tc, rc)
    assert int(tc["pos"]) == SEQ + STEPS


@pytest.fixture(scope="module")
def zamba():
    rcfg = _cfg("zamba2-1.2b")
    return (rcfg,) + _cross(rcfg, seed=3)


def test_hybrid_sharded_long_decode_matches_the_reference(zamba):
    """``decode_step(sharded_long=True)``: on a one-device mesh against the
    reference's own (its multi-device sharded paths fail on this JAX, C2),
    and over 2 shards at budgets covering every tile against the unsharded
    dense decode."""
    rcfg, rp, tcfg, tp = zamba
    tok = _tokens(rcfg, 7)
    nxt = tok[:, -1:]
    rc, _ = r_hy.prefill(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                         "clusterkv")
    rc = r_api.grow_cache(rcfg, rc, CACHE)
    rshd = r_shd.ShardCtx(jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                            ("data",)))
    rl, _ = r_hy.decode_step(rp, rcfg, rc, jnp.asarray(nxt), rshd,
                             "clusterkv", sharded_long=True)

    def ours(cfg, n_dev, sharded=True):
        tc, _ = t_hy.prefill(tp, cfg, {"tokens": torch.from_numpy(tok)},
                             "clusterkv")
        tc = t_api.grow_cache(cfg, tc, CACHE)
        shd = t_shd.ShardCtx(t_mesh.make_mesh((n_dev,), ("data",),
                                              ["cpu"] * n_dev))
        return t_hy.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                                "clusterkv", sharded_long=sharded,
                                shd=shd)[0]

    _close_logits(ours(tcfg, 1), rl)
    n_tiles = CACHE // tcfg.clusterkv.block_k
    cover = tcfg.with_(clusterkv=dataclasses.replace(
        tcfg.clusterkv, blocks_per_query=n_tiles, decode_clusters=n_tiles))
    tc, _ = t_hy.prefill(tp, cover, {"tokens": torch.from_numpy(tok)},
                         "clusterkv")
    tc = t_api.grow_cache(cover, tc, CACHE)
    dense, _ = t_hy.decode_step(tp, cover, tc, torch.from_numpy(nxt),
                                "dense")
    _close_logits(ours(cover, 2), dense)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_decode_matches_prefill_in_float32(arch):
    """Teacher forcing, the reference's ``tests/test_models.py`` case in
    the port: the last logits of ``prefill(S)`` equal ``prefill(S - 1)``
    then one ``decode_step`` of the last token. The chunked scan (chunk
    8 of the reduced zamba2, and chunk 16 here for falcon-mamba, so S = 32
    spans chunks) against the step recurrence."""
    rcfg = r_base.reduced_config(arch).with_(dtype="float32")
    if rcfg.family == "ssm":
        rcfg = rcfg.with_(ssm=dataclasses.replace(rcfg.ssm, chunk=16))
    _, tcfg, tp = _cross(rcfg, seed=2)
    mod = t_api.module_for(tcfg)
    s = 32
    tok = torch.from_numpy(_tokens(rcfg, 8, s=s))
    _, full = mod.prefill(tp, tcfg, {"tokens": tok}, "dense")
    cache, _ = mod.prefill(tp, tcfg, {"tokens": tok[:, :s - 1]}, "dense")
    cache = t_api.grow_cache(tcfg, cache, s)
    lg, cache = mod.decode_step(tp, tcfg, cache, tok[:, s - 1:], "dense")
    np.testing.assert_allclose(tn(lg), tn(full), rtol=2e-3, atol=2e-3)
    assert int(cache["pos"]) == s


def test_hybrid_cache_seq_axes_and_grow_cache_match_the_reference():
    """The hybrid's cache nests its SSM state in a dict: ``cache_seq_axes``
    skips it, as the reference's does, and ``grow_cache`` pads k/v only and
    passes the state on as it is."""
    rcfg = r_base.reduced_config("zamba2-1.2b")
    tcfg = t_base.reduced_config("zamba2-1.2b")
    axes = t_api.cache_seq_axes(tcfg)
    assert axes == r_api.cache_seq_axes(rcfg) == {"k": 3, "v": 3}
    cache = t_hy.init_cache(tcfg, 2, 16, device="cpu")
    cache["ssm"]["h"].normal_()
    grown = t_api.grow_cache(tcfg, cache, 40)
    assert tuple(grown["k"].shape)[3] == tuple(grown["v"].shape)[3] == 40
    assert grown["ssm"] is cache["ssm"]
    assert t_api.cache_seq_axes(t_base.reduced_config("falcon-mamba-7b")) \
        == r_api.cache_seq_axes(r_base.reduced_config("falcon-mamba-7b")) \
        == {}
