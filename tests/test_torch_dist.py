"""The ``dist`` backend (``core/dist.py``), the sharded long-context
decode (``models/attention.py``, ``models/transformer.py``) and the shard
context (``models/sharding.py``), port against reference, on the CPU.

Sharded results are held against single-device ones — the reference's
``apply(x, backend="bsr")``, dense ``decode_attention``, and the
reference's ``clusterkv_decode_sharded`` / ``decode_step(sharded_long=
True)`` on a one-device mesh in this process. The reference's sharded
paths over several (forced) devices are red on this JAX (ROADMAP C2), so
they are not the yardstick. Meshes repeat the CPU device (ROADMAP C32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt

from repro import api as ref_api
from repro.configs import reduced_config as r_reduced
from repro.configs.base import ClusterKVConfig as RCKV
from repro.core import blocksparse as ref_bs
from repro.models import attention as r_attn
from repro.models import model_api as r_api
from repro.models import sharding as r_shd
from repro.models import transformer as r_tf
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.configs.base import ClusterKVConfig as TCKV
from repro_torch.core import registry as t_reg
from repro_torch.core.blocksparse import random_bsr
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import attention as t_attn
from repro_torch.models import model_api as t_mapi
from repro_torch.models import sharding as t_shd
from repro_torch.models import transformer as t_tf

CPU = torch.device("cpu")


def cpu_mesh(n_dev, axes=("data",)):
    shape = (n_dev,) if len(axes) == 1 else (n_dev, 2)
    return t_mesh.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


# -- the dist backend --------------------------------------------------------------


@pytest.mark.parametrize("n,n_dev", [(512, 1), (512, 2), (512, 8),
                                     (320, 8), (320, 3)])
def test_dist_backend_matches_single_device(n, n_dev):
    """Row-block counts that do not divide the mesh (10 over 8 or 3) are
    padded, not rejected; (n, f) charges are rejected, not scrambled."""
    rb = ref_bs.random_bsr(0, n, 32, 4)
    tp = t_api.InteractionPlan.from_bsr(random_bsr(0, n, 32, 4,
                                                   device="cpu"))
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    want = ref_api.InteractionPlan.from_bsr(rb).apply(jnp.asarray(x),
                                                      backend="bsr")
    mesh = cpu_mesh(n_dev)
    y = tp.apply(tt(x), backend="dist", mesh=mesh)
    assert y.shape == (n,)
    assert_close(y, want)
    with pytest.raises(ValueError, match="1-D"):
        tp.apply(torch.ones((n, 2)), backend="dist", mesh=mesh)


def test_dist_backend_on_any_plan_and_mesh():
    rb = ref_bs.random_bsr(0, 320, 32, 4)
    tp = t_api.InteractionPlan.from_bsr(random_bsr(0, 320, 32, 4,
                                                   device="cpu"))
    x = np.random.default_rng(1).standard_normal(320).astype(np.float32)
    want = ref_api.InteractionPlan.from_bsr(rb).apply(jnp.asarray(x),
                                                      backend="bsr")
    assert "dist" in t_reg.backend_names()
    assert_close(tp.apply(tt(x), backend="dist"), want)
    assert_close(tp.apply(tt(x), backend="dist", mesh=cpu_mesh(8)), want)
    assert_close(tp.apply(tt(x), backend="dist",
                          mesh=cpu_mesh(4, ("data", "model"))), want)


def test_dist_backend_name_crosses_unchanged():
    assert t_convert.backend_from_reference("dist") == "dist"
    assert t_convert.backend_to_reference("dist") == "dist"
    assert t_convert.backend_from_reference("pallas") == "cuda"


# -- sharded long-context decode ----------------------------------------------------


def _decode_inputs(seed=0, B=1, Hq=4, Hkv=2, S=256, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, Hkv, S)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_decode_with_full_local_coverage_is_dense(n_dev):
    """The reference test's shapes: every shard selects all its tiles, so
    the combined partials are dense decode attention."""
    q, k, v, pos = _decode_inputs()
    S = k.shape[2]
    cfg = TCKV(enabled=True, block_k=32, decode_clusters=64)
    got = t_attn.clusterkv_decode_sharded(tt(q), tt(k), tt(v), tt(pos),
                                          S - 1, cfg, cpu_mesh(n_dev))
    want = r_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos[0, 0]),
                                   S - 1)
    assert float(np.abs(tn(got) - np.asarray(want)).max()) < 1e-3
    assert_close(got, t_attn.decode_attention(tt(q), tt(k), tt(v),
                                              tt(pos[0, 0]), S - 1))


@pytest.mark.parametrize("clusters,qpos", [(2, 255), (3, 200), (1, 100)])
def test_sharded_decode_selects_like_the_reference(clusters, qpos):
    """A budget that does not cover the cache: the selection matters, and
    the port equals the reference's sharded decode on a one-device mesh."""
    q, k, v, pos = _decode_inputs(seed=clusters)
    want = r_attn.clusterkv_decode_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        qpos, RCKV(enabled=True, block_k=32, decode_clusters=clusters),
        jax.make_mesh((1,), ("data",)))
    got = t_attn.clusterkv_decode_sharded(
        tt(q), tt(k), tt(v), tt(pos), qpos,
        TCKV(enabled=True, block_k=32, decode_clusters=clusters),
        cpu_mesh(1))
    assert_close(got, want)


def _cfg(clusters):
    return r_reduced("qwen2-0.5b").with_(
        dtype="float32",
        clusterkv=RCKV(enabled=True, block_q=32, block_k=32,
                       blocks_per_query=2, decode_clusters=clusters))


@pytest.fixture(scope="module")
def model():
    rcfg = _cfg(2)
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(0))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    return rcfg, rp, tcfg, tp


def _prefilled(model, tokens, max_seq):
    rcfg, rp, tcfg, tp = model
    rc, rl = r_tf.prefill(rp, rcfg, {"tokens": jnp.asarray(tokens)},
                          r_shd.NO_SHARD, "clusterkv")
    tc, _ = t_tf.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                         "clusterkv")
    nxt = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
    return (r_api.grow_cache(rcfg, rc, max_seq),
            t_mapi.grow_cache(tcfg, tc, max_seq), nxt)


def test_sharded_long_decode_steps_match_the_reference(model):
    """``decode_step(sharded_long=True)`` with a mesh in ``shd``: on a
    one-device mesh the reference's own sharded step runs in this process
    and the two agree step by step (budget 2 of 4 tiles)."""
    rcfg, rp, tcfg, tp = model
    tok = np.random.default_rng(5).integers(0, 256, (1, 96)).astype(np.int32)
    rc, tc, nxt = _prefilled(model, tok, 128)
    # a mesh of automatic axes: the reference's activation constraints
    # refuse explicit ones
    rshd = r_shd.ShardCtx(jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                            ("data",)))
    tshd = t_shd.ShardCtx(cpu_mesh(1))
    for _ in range(3):
        rlg, rc = r_tf.decode_step(rp, rcfg, rc, jnp.asarray(nxt), rshd,
                                   "clusterkv", sharded_long=True)
        tlg, tc = t_tf.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                   "clusterkv", sharded_long=True, shd=tshd)
        assert_close(tlg, rlg)
        nxt = np.asarray(jnp.argmax(rlg, -1))[:, None].astype(np.int32)
    assert_close(tc["k"], rc["k"])


def test_sharded_long_decode_at_a_covering_budget_is_the_unsharded_one():
    """Four shards of a 128-slot cache, every tile selected on each side:
    the sharded steps give the unsharded steps' tokens and logits."""
    rcfg = _cfg(64)
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(0))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                         device="cpu")
    tok = np.random.default_rng(6).integers(0, 256, (1, 96)).astype(np.int32)
    _, tc, nxt = _prefilled((rcfg, rp, tcfg, tp), tok, 128)
    ts = {key: (val.clone() if torch.is_tensor(val) else val)
          for key, val in tc.items()}
    shd = t_shd.ShardCtx(cpu_mesh(4))
    a, b = torch.from_numpy(nxt), torch.from_numpy(nxt)
    for _ in range(4):
        la, tc = t_tf.decode_step(tp, tcfg, tc, a, "clusterkv")
        lb, ts = t_tf.decode_step(tp, tcfg, ts, b, "clusterkv",
                                  sharded_long=True, shd=shd)
        scale = float(la.abs().max())
        assert float((la - lb).abs().max()) <= 1e-3 * scale
        a, b = la.argmax(-1)[:, None], lb.argmax(-1)[:, None]
        assert torch.equal(a, b)
    # without a mesh the flag changes nothing, as in the reference
    lc, _ = t_tf.decode_step(tp, tcfg, tc, a, "clusterkv", sharded_long=True)
    assert lc.shape == la.shape


# -- the shard context ----------------------------------------------------------


def test_the_shard_context_and_shardings_for():
    tmesh = cpu_mesh(2, ("data", "model"))
    x = torch.ones(3)
    assert t_shd.ShardCtx(tmesh).cst(x, "dp") is x
    assert t_shd.ShardCtx(tmesh).mesh == tmesh
    assert t_shd.NO_SHARD.mesh is None
    with pytest.raises(NotImplementedError, match="A14"):
        t_shd.shardings_for({}, {}, tmesh)
