"""The serving slice as a whole: configs, the dense LM and the
continuous-batching ``Engine``, against the reference.

The reference's float32 parameters of ``reduced_config("qwen2-0.5b")``
cross over by ``convert.params_from_reference``; ``prefill``,
``decode_step`` (scalar and per-slot positions) and ``plan_prefill`` logits
must agree to float32 ``rtol 1e-5``, and the port's ``Engine`` must give the
reference ``Engine``'s greedy tokens token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn

from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced
from repro.configs.base import ClusterKVConfig as RCKV
from repro.core import clusterkv as r_ckv
from repro.models import model_api as r_api
from repro.models import transformer as r_tf
from repro.models.sharding import NO_SHARD
from repro.train.serve_loop import Engine as REngine
from repro.train.serve_loop import Request as RRequest
from repro_torch import convert as t_convert
from repro_torch.configs import base as t_base
from repro_torch.models import model_api as t_api
from repro_torch.models import transformer as t_tf
from repro_torch.train.serve_loop import Engine as TEngine
from repro_torch.train.serve_loop import Request as TRequest


def _cfg(n_sel=2, clusters=2):
    return r_reduced("qwen2-0.5b").with_(
        dtype="float32",
        clusterkv=RCKV(enabled=True, block_q=32, block_k=32,
                       blocks_per_query=n_sel, decode_clusters=clusters))


@pytest.fixture(scope="module")
def model():
    rcfg = _cfg()
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(0))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    return rcfg, rp, tcfg, tp


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_qwen_configs_match_the_reference():
    for get in ("CONFIG", "REDUCED"):
        ref = (r_get_config("qwen2-0.5b") if get == "CONFIG"
               else r_reduced("qwen2-0.5b"))
        ours = (t_base.get_config("qwen2-0.5b") if get == "CONFIG"
                else t_base.reduced_config("qwen2-0.5b"))
        # use_pallas=False crosses over as "auto": the device picks the path
        assert t_convert.config_from_reference(ref) == ours
        r, t = dataclasses.asdict(ref), dataclasses.asdict(ours)
        r_ckv_d, t_ckv_d = r.pop("clusterkv"), t.pop("clusterkv")
        assert r == t
        assert r_ckv_d.pop("use_pallas") is False
        assert t_ckv_d.pop("use_kernel") == "auto"
        assert r_ckv_d.pop("decode_backend") == "auto"
        assert t_ckv_d.pop("decode_backend") == "auto"
        assert r_ckv_d == t_ckv_d
    cfg = t_base.get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (24, 896, 14, 2, 64, 4864,
                                                   151936)
    assert cfg.qkv_bias and cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    ckv = cfg.clusterkv
    assert (ckv.enabled, ckv.block_q, ckv.block_k, ckv.blocks_per_query,
            ckv.decode_clusters, ckv.local_window_blocks, ckv.embed_dim) \
        == (True, 128, 128, 16, 16, 1, 3)


def test_config_from_reference_maps_the_renamed_fields():
    ref = _cfg().with_(clusterkv=RCKV(enabled=True, use_pallas=True,
                                      decode_backend="pallas"))
    ours = t_convert.config_from_reference(ref)
    assert ours.clusterkv.use_kernel == "auto"
    assert ours.clusterkv.decode_backend == "auto"
    ours = t_convert.config_from_reference(
        dataclasses.asdict(ref.with_(clusterkv=RCKV(decode_backend="xla"))))
    assert ours.clusterkv.decode_backend == "auto"
    assert ours.clusterkv.use_kernel == "auto"
    bad = dataclasses.asdict(ref)
    bad["clusterkv"]["decode_backend"] = "triton"
    with pytest.raises(ValueError, match="no counterpart"):
        t_convert.config_from_reference(bad)
    bad = dict(dataclasses.asdict(ref), colour="red")
    with pytest.raises(ValueError, match="unknown ModelConfig fields"):
        t_convert.config_from_reference(bad)


def test_unported_architectures_and_families_raise():
    with pytest.raises(NotImplementedError, match="A13b"):
        t_base.get_config("falcon-mamba-7b")
    with pytest.raises(KeyError, match="unknown arch"):
        t_base.get_config("gpt-17")
    cfg = t_base.reduced_config("qwen2-0.5b")
    with pytest.raises(NotImplementedError, match="A13b"):
        t_api.module_for(cfg.with_(family="ssm"))
    with pytest.raises(NotImplementedError, match="A13b"):
        t_api.cache_seq_axes(cfg.with_(family="hybrid"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_api.init(cfg, torch.Generator())   # device None means "cuda"


def test_params_from_reference_checks_the_tree(model):
    rcfg, rp, tcfg, tp = model
    pnp = jax.tree.map(np.asarray, rp)
    assert t_api.cache_seq_axes(tcfg) == r_api.cache_seq_axes(rcfg)
    leaves = jax.tree.leaves(pnp)
    assert sum(x.size for x in leaves) == sum(
        x.numel() for x in t_tf.pm.tree_leaves(tp))
    bad = jax.tree.map(lambda a: a, pnp)
    bad["ln_f"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="/ln_f/scale: shape"):
        t_convert.params_from_reference(bad, tcfg, device="cpu")
    del bad["ln_f"]
    with pytest.raises(ValueError, match="has keys"):
        t_convert.params_from_reference(bad, tcfg, device="cpu")
    # the port's own random init has the same layout
    own = t_api.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, pnp)) == \
        jax.tree.structure(t_tf.pm.tree_map(lambda a: 0, own))


@pytest.mark.parametrize("backend", ["flash", "dense", "clusterkv"])
def test_prefill_and_forward_match_reference(model, backend):
    rcfg, rp, tcfg, tp = model
    tok = _tokens(1, (2, 128))
    rc, rl = r_tf.prefill(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                          backend)
    tc, tl = t_tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                          backend)
    assert_close(tl, rl)
    assert_close(tc["k"], rc["k"])
    assert_close(tc["v"], rc["v"])
    assert int(tc["pos"]) == int(rc["pos"])
    rh, _ = r_tf.forward(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                         backend)
    th, _ = t_tf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                         backend)
    assert_close(th, rh)


@pytest.mark.parametrize("backend", ["flash", "clusterkv"])
def test_decode_steps_match_reference(model, backend):
    rcfg, rp, tcfg, tp = model
    tok = _tokens(2, (2, 96))
    rc, rl = r_tf.prefill(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                          backend)
    tc, tl = t_tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                          backend)
    rc = r_api.grow_cache(rcfg, rc, 160)
    tc = t_api.grow_cache(tcfg, tc, 160)
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    for _ in range(3):                         # scalar positions
        rlg, rc = r_tf.decode_step(rp, rcfg, rc, jnp.asarray(nxt), NO_SHARD,
                                   backend)
        tlg, tc = t_tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                   backend)
        assert_close(tlg, rlg)
        nxt = np.asarray(jnp.argmax(rlg, -1))[:, None].astype(np.int32)
    assert_close(tc["k"], rc["k"])
    pos = np.array([99, 130], np.int32)        # per-slot positions
    rlg, rc = r_tf.decode_step(rp, rcfg, dict(rc, pos=jnp.asarray(pos)),
                               jnp.asarray(nxt), NO_SHARD, backend)
    tlg, tc = t_tf.decode_step(tp, tcfg, dict(tc, pos=torch.from_numpy(pos)),
                               torch.from_numpy(nxt), backend)
    assert_close(tlg, rlg)
    assert_close(tc["v"], rc["v"])
    np.testing.assert_array_equal(tn(tc["pos"]), np.asarray(rc["pos"]))


def test_plan_prefill_with_the_references_key_plans(model):
    """``plan_prefill`` through per-layer orderings: the reference's own
    ``kv_plan_batch`` orderings cross over as a tensor (ROADMAP C4), and
    the sparse budget (2 of 4 tiles) makes the ordering matter."""
    rcfg, rp, tcfg, tp = model
    tok = _tokens(3, (1, 128))
    rc, _ = r_tf.prefill(rp, rcfg, {"tokens": jnp.asarray(tok)}, NO_SHARD,
                         "clusterkv")
    perms = np.stack([np.asarray(r_ckv.plan_batch_perm(
        r_ckv.kv_plan_batch(rc["k"][i]), (1, 2)))
        for i in range(rcfg.n_layers)])
    want = r_tf.plan_prefill(rp, rcfg, {"tokens": jnp.asarray(tok)},
                             jnp.asarray(perms), NO_SHARD)
    got = t_tf.plan_prefill(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                            torch.from_numpy(perms))
    assert_close(got, want)


def _engine_run(engine_cls, request_cls, cfg, params, prompts, backend,
                **kw):
    eng = engine_cls(cfg, params, slots=2, max_seq=256, prefill_bucket=64,
                     backend=backend, **kw)
    reqs = [request_cls(rid=i, tokens=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.output for r in reqs]


@pytest.mark.parametrize("backend", ["flash", "clusterkv"])
def test_engine_token_for_token_against_reference(model, backend):
    rcfg, rp, tcfg, tp = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, int(rng.integers(16, 60))).astype(
        np.int32) for _ in range(5)]
    _, want = _engine_run(REngine, RRequest, rcfg, rp, prompts, backend)
    eng, got = _engine_run(TEngine, TRequest, tcfg, tp, prompts, backend,
                           device="cpu")
    assert got == want
    assert eng.ticks > 0 and len(eng.timings["prefill_s"]) == 5
    assert len(eng.timings["tick_s"]) == eng.ticks
    assert sorted(eng.first_logits) == list(range(5))


def test_covering_budget_engine_equals_flash_engine(model):
    """Budgets that cover every tile make ClusterKV exact: the port's
    ClusterKV engine gives its own flash engine's tokens (the check
    ``chip_smoke.py`` makes at full width on the card)."""
    _, rp, _, _ = model
    rcfg = _cfg(n_sel=8, clusters=8)
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (40, 100)]
    e1, flash = _engine_run(TEngine, TRequest, tcfg, tp, prompts, "flash",
                            device="cpu")
    e2, ckv = _engine_run(TEngine, TRequest, tcfg, tp, prompts, "clusterkv",
                          device="cpu")
    assert flash == ckv
    for rid in range(2):
        scale = float(e1.first_logits[rid].abs().max())
        assert float((e1.first_logits[rid] - e2.first_logits[rid])
                     .abs().max()) <= 1e-3 * scale


def test_engine_rejects_a_prompt_beyond_max_seq(model):
    _, _, tcfg, tp = model
    eng = TEngine(tcfg, tp, slots=1, max_seq=64, prefill_bucket=64,
                  device="cpu")
    eng.submit(TRequest(rid=0, tokens=np.ones(70, np.int32)))
    with pytest.raises(ValueError, match="max_seq=64"):
        eng.run()
