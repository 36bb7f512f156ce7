"""The decoder-only model zoo (ROADMAP A13a) against the reference: the MoE
FFN, MLA attention, the vlm and SWA paths and their six configs.

The reference's float32 parameters of each reduced config cross over by
``convert.params_from_reference``; the same numpy inputs go through both
packages on the CPU (the reference's ClusterKV path through XLA, the
port's through the plain versions of its kernels). Tolerances:

* MoE routing integers (top-k expert ids, the stable expert sort, the keep
  mask, the buffer rows) exactly, on tie-free router logits; ``y`` within
  ``rtol 1e-5`` and ``1e-6 x max|y|``, ``aux`` within ``1e-6``: float32
  products summed in another order.
* logits of ``prefill`` and each ``decode_step`` within ``1e-4 x
  max|logits|``: a whole model's float32 sums, layer over layer.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt

from repro.configs import base as r_base
from repro.configs.base import ClusterKVConfig as RCKV
from repro.models import mla as r_mla
from repro.models import model_api as r_api
from repro.models import moe as r_moe
from repro.models import sharding as r_shd
from repro.models import transformer as r_tf
from repro.models.sharding import NO_SHARD
from repro.serve import ClusterKVEngine as RService
from repro.train.serve_loop import Engine as REngine
from repro.train.serve_loop import Request as RRequest
from repro_torch import convert as t_convert
from repro_torch.configs import base as t_base
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import mla as t_mla
from repro_torch.models import model_api as t_api
from repro_torch.models import moe as t_moe
from repro_torch.models import param as t_pm
from repro_torch.models import sharding as t_shd
from repro_torch.models import transformer as t_tf
from repro_torch.serve import ClusterKVEngine
from repro_torch.train.serve_loop import Engine as TEngine
from repro_torch.train.serve_loop import Request as TRequest

ZOO = ["granite-moe-3b-a800m", "h2o-danube-3-4b", "minicpm3-4b",
       "llava-next-34b", "mistral-large-123b", "llama4-maverick-400b-a17b"]
A13B = ["falcon-mamba-7b", "zamba2-1.2b", "whisper-medium"]
SEQ, CACHE, STEPS = 64, 128, 3
LOGIT_TOL = 1e-4


def _rcfg(arch, **ckv):
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


@pytest.fixture(scope="module", params=ZOO)
def zoo_model(request):
    rcfg = _rcfg(request.param)
    return (request.param, rcfg) + _cross(rcfg)


def _batch(cfg, seed, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeddings": x}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close_logits(port, ref):
    ref = tn(ref)
    np.testing.assert_allclose(tn(port), ref, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_configs_and_cells_match_the_reference(arch):
    """Field for field, apart from ClusterKV's two renamed fields (C11),
    for the full and the reduced config; the same cells."""
    for ref, ours in ((r_base.get_config(arch), t_base.get_config(arch)),
                      (r_base.reduced_config(arch),
                       t_base.reduced_config(arch))):
        assert t_convert.config_from_reference(ref) == ours
        r, t = dataclasses.asdict(ref), dataclasses.asdict(ours)
        r_ckv, t_ckv = r.pop("clusterkv"), t.pop("clusterkv")
        assert r == t
        assert r_ckv.pop("use_pallas") is False
        assert t_ckv.pop("use_kernel") == "auto"
        assert r_ckv == t_ckv
    assert list(t_base.cells(arch)) == list(r_base.cells(arch))
    assert t_api.module_for(t_base.get_config(arch)) is t_tf


def test_registry_and_all_cells():
    assert t_base.ARCH_IDS == r_base.ARCH_IDS
    assert list(t_base.all_cells()) == list(r_base.all_cells())
    assert set(A13B) < set(t_base.ARCH_IDS)


@pytest.mark.parametrize("arch", ZOO + A13B)
def test_param_shapes_match_the_reference_at_full_width(arch):
    """The whole parameter tree on the ``meta`` device (no memory): every
    leaf's shape and dtype as the reference's ``param_shapes``."""
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       r_api.param_shapes(r_base.get_config(arch)))
    ours = t_pm.tree_map(lambda t: (tuple(t.shape),
                                    str(t.dtype).replace("torch.", "")),
                         t_api.param_shapes(t_base.get_config(arch)))
    assert ours == ref
    assert all(t.device.type == "meta" for t in t_pm.tree_leaves(
        t_api.param_shapes(t_base.get_config(arch))))


def test_backend_for_and_make_small_batch_match_the_reference():
    for arch in ZOO + A13B + ["qwen2-0.5b"]:
        rcfg, tcfg = r_base.get_config(arch), t_base.get_config(arch)
        for shape in r_base.SHAPES:
            for use in (False, True):
                assert t_api.backend_for(tcfg, shape, use) == \
                    r_api.backend_for(rcfg, shape, use)
        rcfg, tcfg = r_base.reduced_config(arch), t_base.reduced_config(arch)
        for kind in ("train", "prefill"):
            ref = r_api.make_small_batch(rcfg, jax.random.PRNGKey(0), 2, 16,
                                         kind)
            ours = t_api.make_small_batch(tcfg, torch.Generator(), 2, 16,
                                          kind, device="cpu")
            assert sorted(ours) == sorted(ref)
            for key in ref:
                assert tuple(ours[key].shape) == ref[key].shape
                assert ours[key].is_floating_point() == \
                    jnp.issubdtype(ref[key].dtype, jnp.floating)
            if "tokens" in ours:
                assert 0 <= int(ours["tokens"].min()) and \
                    int(ours["tokens"].max()) < tcfg.vocab


def test_materialize_draws_in_place_in_the_parameter_dtype(monkeypatch):
    """Each leaf is allocated once in its dtype and drawn in float32 chunks
    cast into place: a bf16 tree is the float32 tree's draws rounded, and
    chunking reproduces itself; the ``meta`` device draws nothing."""
    cfg = t_base.reduced_config("granite-moe-3b-a800m")
    monkeypatch.setattr(t_pm, "CHUNK", 1000)
    f32 = t_tf.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    b16 = t_tf.init_lm(cfg, torch.Generator().manual_seed(3), "cpu",
                       torch.bfloat16)
    for a, b in zip(t_pm.tree_leaves(f32), t_pm.tree_leaves(b16)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    assert torch.equal(f32["layers"]["ln1"]["scale"],
                       torch.ones(cfg.n_layers, cfg.d_model))
    w = f32["layers"]["ffn"]["wg"]                    # (L, E, d, f)
    assert abs(float(w.std()) * math.sqrt(cfg.d_model) - 1.0) < 0.05
    meta = t_api.param_shapes(cfg)
    assert [tuple(t.shape) for t in t_pm.tree_leaves(meta)] == \
        [tuple(t.shape) for t in t_pm.tree_leaves(f32)]


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


def _ref_routing(x, w, k, n_experts, cap):
    """The reference's router and ``_route_local`` sort, line for line
    (``repro.models.moe``), returning its integers."""
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32) @ w, axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    eidx = eidx.reshape(-1, k)
    t = eidx.shape[0]
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=n_experts)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k) - starts[sorted_e]
    keep = rank < cap
    dest = sorted_e * cap + jnp.minimum(rank, cap - 1)
    return [np.asarray(a) for a in (eidx, order, keep, dest, order // k)]


@pytest.mark.parametrize("case", ["no_drops", "drops", "shared"])
def test_moe_ffn_matches_the_reference(case):
    arch = ("llama4-maverick-400b-a17b" if case == "shared"
            else "granite-moe-3b-a800m")
    base = r_base.reduced_config(arch)
    m = base.moe
    cf = {"no_drops": float(m.n_experts), "drops": 0.5,
          "shared": m.capacity_factor}[case]
    rcfg = base.with_(dtype="float32",
                      moe=dataclasses.replace(m, capacity_factor=cf))
    tcfg = t_convert.config_from_reference(rcfg)
    rp, _ = r_moe.init_moe(jax.random.PRNGKey(1), rcfg)
    pnp = jax.tree.map(np.asarray, rp)
    tp = t_pm.tree_map(tt, pnp)
    assert ("shared" in tp) == (case == "shared")
    x = np.random.default_rng(2).standard_normal(
        (2, 16, rcfg.d_model)).astype(np.float32)
    ry, raux = r_moe.moe_ffn(rp, jnp.asarray(x), rcfg, NO_SHARD)
    ty, taux = t_moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    t, k, e = 32, m.top_k, m.n_experts
    cap = max(1, math.ceil(t * k * cf / e))
    want = _ref_routing(x.reshape(t, -1), pnp["router"]["w"], k, e, cap)
    _, _, eidx = t_moe.router(tp, torch.from_numpy(x), tcfg)
    got = [tn(a) for a in (eidx.reshape(t, k),)
           + t_moe.route(eidx.reshape(t, k), e, cap)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dropped = int((~want[2]).sum())
    if case != "shared":
        assert (dropped > 0) == (case == "drops")
    scale = float(np.abs(tn(ry)).max())
    np.testing.assert_allclose(tn(ty), tn(ry), rtol=1e-5, atol=1e-6 * scale)
    assert abs(float(taux) - float(raux)) <= 1e-6
    # the dispatch and combine write in a fixed order: bit-equal again
    assert torch.equal(t_moe.moe_ffn(tp, torch.from_numpy(x), tcfg)[0], ty)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_model():
    rcfg = _rcfg("minicpm3-4b")
    return (rcfg,) + _cross(rcfg, seed=5)


@pytest.mark.parametrize("backend", ["dense", "flash", "clusterkv"])
def test_mla_attention_matches_the_reference(mla_model, backend):
    rcfg, rp, tcfg, tp = mla_model
    lp_r = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    lp_t = t_pm.layer(tp["layers"], 0)["attn"]
    x = np.random.default_rng(6).standard_normal(
        (2, SEQ, rcfg.d_model)).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)
    want = r_mla.mla_attention(lp_r, jnp.asarray(x), jnp.asarray(pos), rcfg,
                               NO_SHARD, backend)
    got = t_mla.mla_attention(lp_t, torch.from_numpy(x),
                              torch.from_numpy(pos), tcfg, backend=backend)
    assert_close(got, want)


def test_mla_prefill_cache_and_absorbed_decode_match_the_reference(
        mla_model):
    """The latent cache of ``prefill`` and the absorbed ``decode_step``."""
    rcfg, rp, tcfg, tp = mla_model
    rb, tb = _both(_batch(rcfg, 7))
    rc, rl = r_tf.prefill(rp, rcfg, rb, NO_SHARD, "clusterkv")
    tc, tl = t_tf.prefill(tp, tcfg, tb, "clusterkv")
    assert sorted(tc) == sorted(rc) == ["c", "kr", "pos"]
    assert_close(tc["c"], rc["c"])
    assert_close(tc["kr"], rc["kr"])
    _close_logits(tl, rl)
    rc, tc = r_api.grow_cache(rcfg, rc, CACHE), t_api.grow_cache(tcfg, tc,
                                                                 CACHE)
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(STEPS):
        rl, rc = r_tf.decode_step(rp, rcfg, rc, jnp.asarray(nxt), NO_SHARD,
                                  "clusterkv")
        tl, tc = t_tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                  "clusterkv")
        _close_logits(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    assert_close(tc["c"], rc["c"])
    assert int(tc["pos"]) == int(rc["pos"]) == SEQ + STEPS
    with pytest.raises(ValueError, match="scalar cache position"):
        t_tf.decode_step(tp, tcfg, dict(tc, pos=torch.tensor([70, 71])),
                         torch.from_numpy(nxt), "clusterkv")


def _mla_latent_inputs(cfg, seed, b=1):
    rng = np.random.default_rng(seed)
    _, kr, dn, dr, _ = r_mla._dims(cfg)
    h = cfg.n_heads
    return (rng.standard_normal((b, h, dn)).astype(np.float32),
            rng.standard_normal((b, h, dr)).astype(np.float32),
            rng.standard_normal((b, CACHE, kr)).astype(np.float32),
            rng.standard_normal((b, CACHE, dr)).astype(np.float32))


def test_mla_latent_decode_sharded_matches_the_reference(mla_model):
    """``_latent_decode_sharded`` on a one-device mesh against the
    reference's own (its multi-device paths are red on this JAX, C2), and
    over 2 and 4 shards at a covering budget against the dense absorbed
    attention."""
    rcfg, rp, tcfg, tp = mla_model
    lp_r = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    lp_t = t_pm.layer(tp["layers"], 0)["attn"]
    qn, qr, cc, krc = _mla_latent_inputs(rcfg, 8)
    kpos = np.arange(CACHE, dtype=np.int32)
    qpos = 100
    rshd = r_shd.ShardCtx(jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                            ("data",)))
    want = r_mla._absorbed_scores_attend(
        lp_r, jnp.asarray(qn), jnp.asarray(qr), jnp.asarray(cc),
        jnp.asarray(krc), jnp.asarray(kpos), qpos, rcfg, rshd, "clusterkv",
        True)

    def ours(cfg, n_dev):
        shd = t_shd.ShardCtx(t_mesh.make_mesh((n_dev,), ("data",),
                                              ["cpu"] * n_dev))
        return t_mla._absorbed_scores_attend(
            lp_t, torch.from_numpy(qn), torch.from_numpy(qr),
            torch.from_numpy(cc), torch.from_numpy(krc),
            torch.from_numpy(kpos), qpos, cfg, shd, "clusterkv", True)

    assert_close(ours(tcfg, 1), want)
    cover = tcfg.with_(clusterkv=dataclasses.replace(tcfg.clusterkv,
                                                     decode_clusters=8))
    dense = t_mla._absorbed_scores_attend(
        lp_t, torch.from_numpy(qn), torch.from_numpy(qr),
        torch.from_numpy(cc), torch.from_numpy(krc), torch.from_numpy(kpos),
        qpos, cover, t_shd.NO_SHARD, "clusterkv", False)
    for n_dev in (2, 4):
        assert_close(ours(cover, n_dev), dense)


# ---------------------------------------------------------------------------
# each architecture end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "flash", "clusterkv"])
def test_prefill_then_decode_matches_the_reference(zoo_model, backend):
    """``prefill`` of a 64-token batch, then 3 ``decode_step``s in a cache
    of 128 (llava continues from (B, 1, d) embeddings; danube's window of
    32 bites)."""
    arch, rcfg, rp, tcfg, tp = zoo_model
    rb, tb = _both(_batch(rcfg, 9))
    rc, rl = r_tf.prefill(rp, rcfg, rb, NO_SHARD, backend)
    tc, tl = t_tf.prefill(tp, tcfg, tb, backend)
    _close_logits(tl, rl)
    rc, tc = r_api.grow_cache(rcfg, rc, CACHE), t_api.grow_cache(tcfg, tc,
                                                                 CACHE)
    rng = np.random.default_rng(10)
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(STEPS):
        if rcfg.embedding_inputs:
            nxt = rng.standard_normal((2, 1, rcfg.d_model)).astype(
                np.float32)
        rl, rc = r_tf.decode_step(rp, rcfg, rc, jnp.asarray(nxt), NO_SHARD,
                                  backend)
        tl, tc = t_tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                  backend)
        _close_logits(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for key in rc:
        if key != "pos":
            assert_close(tc[key], rc[key], atol=1e-4)


def test_forward_and_aux_loss_match_the_reference(zoo_model):
    """``forward``'s hidden states and its aux loss summed over layers (the
    MoE load-balance loss; 0 elsewhere)."""
    arch, rcfg, rp, tcfg, tp = zoo_model
    rb, tb = _both(_batch(rcfg, 11))
    rh, raux = r_tf.forward(rp, rcfg, rb, NO_SHARD, "flash")
    th, taux = t_tf.forward(tp, tcfg, tb, "flash")
    assert_close(th, rh, atol=1e-4)
    assert abs(float(taux) - float(raux)) <= 1e-6 * max(1.0, float(raux))
    assert (float(taux) > 0) == (rcfg.moe is not None)


# ---------------------------------------------------------------------------
# serving a MoE model
# ---------------------------------------------------------------------------


def _prompts(seed, n=4, lo=16, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def granite():
    rcfg = _rcfg("granite-moe-3b-a800m", block_q=32, block_k=32,
                 blocks_per_query=4, decode_clusters=4)
    return (rcfg,) + _cross(rcfg, seed=12)


@pytest.mark.parametrize("backend", ["flash", "clusterkv"])
def test_engine_serves_granite_as_the_reference(granite, backend):
    rcfg, rp, tcfg, tp = granite
    prompts = _prompts(13)

    def run(cls, req, cfg, params, **kw):
        eng = cls(cfg, params, slots=2, max_seq=128, prefill_bucket=32,
                  backend=backend, **kw)
        return _serve(eng, [req(rid=i, tokens=p, max_new=5)
                            for i, p in enumerate(prompts)])

    assert run(TEngine, TRequest, tcfg, tp, device="cpu") == \
        run(REngine, RRequest, rcfg, rp)


def test_plan_service_serves_granite_as_the_reference(granite):
    """``ClusterKVEngine(mode="plan", plan_prefill=True)`` on reduced
    granite: the MoE FFN in ``plan_prefill`` and ``plan_decode_step``,
    token for token against the reference service."""
    rcfg, rp, tcfg, tp = granite
    prompts = _prompts(14)
    svc = ClusterKVEngine(tcfg, tp, slots=2, max_seq=128, prefill_bucket=32,
                          plan_prefill=True, device="cpu")
    got = _serve(svc, [TRequest(rid=i, tokens=p, max_new=5)
                       for i, p in enumerate(prompts)])
    ref = RService(rcfg, rp, slots=2, max_seq=128, prefill_bucket=32,
                   mode="plan", plan_prefill=True)
    want = _serve(ref, [RRequest(rid=i, tokens=p, max_new=5)
                        for i, p in enumerate(prompts)])
    assert got == want
    assert svc.report()["decode_traces"] == 1


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_what_the_zoo_does_not_serve_raises(granite, mla_model):
    _, _, tcfg, tp = granite
    shd = t_shd.ShardCtx(t_mesh.make_mesh((1,), ("data",), ["cpu"]))
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="A14"):
        t_moe.moe_ffn(t_pm.layer(tp["layers"], 0)["ffn"], x, tcfg, shd)
    cache = t_tf.init_cache(tcfg, 1, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        t_tf.decode_step(tp, tcfg, cache, torch.zeros((1, 1),
                                                      dtype=torch.int64),
                         "clusterkv", sharded_long=True, shd=shd)
    _, _, mcfg, mp = mla_model
    with pytest.raises(NotImplementedError, match="MLA"):
        TEngine(mcfg, mp, slots=1, max_seq=64, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        ClusterKVEngine(mcfg, mp, slots=1, max_seq=64, mode="percall",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="GQA"):
        ClusterKVEngine(mcfg, mp, slots=1, max_seq=64, device="cpu")
    with pytest.raises(NotImplementedError, match="plan prefill"):
        t_tf.plan_prefill(mp, mcfg, {"tokens": torch.zeros((1, 16),
                                                          dtype=torch.int64)},
                          None)
