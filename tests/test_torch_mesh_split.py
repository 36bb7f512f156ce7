"""What the mesh steps split over the tensor axis (ROADMAP C44, C48, C49):
every leaf the reference's ``param_specs`` split over ``tp``, with counts
the axis does not divide.

- Train, prefill and decode on a (1, 4) ("data", "model") ``gloo`` mesh
  (``_torch_mesh_harness.split_cases``: ``tp`` = 4, no batch split) against
  the reference's steps jitted on its (1, 4) auto-axis mesh
  (``jax.sharding.Mesh``: its ``jax.make_mesh`` meshes fail, ROADMAP C2)
  in two subprocesses, on the same parameters, batch, prompts, caches and
  tokens. The reduced configs are cut so that the splits are uneven: 6
  query heads in 2 kv groups (fewer kv heads than ranks: each kv head on
  two ranks, its 3 query heads split 2 + 1) and a vocab of 250 (63, 63,
  63, 61 rows); MLA with 6 heads (2, 1, 2, 1); mamba1's 128 inner channels
  and mamba2's 8 heads; the hybrid's shared block with 2 heads (two ranks
  hold no query head). Tolerances are ``test_torch_mesh.py``'s (train) and
  ``test_torch_mesh_serve.py``'s (serving).
- ``model_api.compute_specs`` on a fake (16, 16) and (1, 4) world names the
  tensor axis (or a ``sharding.Part`` of it) for every leaf whose
  reference ``param_specs`` name ``tp``, for every architecture.
- A fake-world dry run of a reduced dense config with 8 query heads in 2
  kv groups and a vocab of 250, on (1, 4) and (1, 1): a rank's traced
  FLOPs at ``tp`` = 4 within 1.3x of the ``tp`` = 1 trace / 4; and the
  same cell traced on a fake (1, 4) world against the step run for real on
  four gloo ranks under the same counters.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_mesh_harness as H

from repro.configs import base as r_base
from repro.models import model_api as r_api
from repro.optim import optimizers as r_opt
from repro_torch.configs import ARCH_IDS

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE = (1, 4)
# (name, arch, config overrides): counts the 4-way axis does not divide
CASES = [
    ("gqa-kv2", "qwen2-0.5b", {"n_heads": 6, "n_kv_heads": 2, "vocab": 250}),
    ("mla-6", "minicpm3-4b", {"n_heads": 6, "n_kv_heads": 6, "vocab": 250}),
    ("mamba1", "falcon-mamba-7b", {"vocab": 250}),
    ("mamba2", "zamba2-1.2b", {"n_heads": 2, "n_kv_heads": 2,
                               "vocab": 250})]
LOSS_RTOL = 1e-5
SERVE_TOL = 1e-4
PROMPT, MAX_SEQ, POS, DECODE_STEPS = 32, 64, 40, 2

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import base
from repro.data import pipeline
from repro.models import model_api
from repro.models.sharding import ShardCtx, shardings_for
from repro.optim.optimizers import make_optimizer
from repro.train import trainer

def nest(flat, prefix):
    out = {}
    for key, val in flat.items():
        if key.startswith(prefix + "/"):
            *path, last = key[len(prefix) + 1:].split("/")
            d = out
            for k in path:
                d = d.setdefault(k, {})
            d[last] = jnp.asarray(val)
    return out

def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "/" + k, out)
    else:
        out[prefix] = np.asarray(tree)
    return out

def bspec(b, mesh):
    return shardings_for(b, {k: P("dp", *([None] * (v.ndim - 1)))
                             for k, v in b.items()}, mesh)

mesh = Mesh(np.array(jax.devices()).reshape(SHAPE), ("data", "model"))
for name, arch, over in CASES:
    cfg = base.reduced_config(arch).with_(dtype="float32", **over)
    mod = model_api.module_for(cfg)
    opt = make_optimizer("adamw", lr=1e-3, warmup=1, total=10)
    step, _ = trainer.make_train_step(cfg, mesh, "flash", optimizer=opt)
    init = dict(np.load(os.path.join(OUT, name + "_init.npz")))
    params, state = nest(init, "p0"), nest(init, "s0")
    state["step"] = state["step"].astype(jnp.int32)
    specs = model_api.param_specs(cfg)
    pspec = shardings_for(params, specs, mesh)
    ospec = shardings_for(state, opt.state_specs(specs), mesh)
    batch = {k: jnp.asarray(v) for k, v in
             pipeline.token_batch(cfg, 0, 4, 32).items()}

    def both(p, s, b):
        g = jax.grad(lambda q: mod.loss_fn(q, cfg, b, ShardCtx(mesh),
                                           "flash"))(p)
        return step(p, s, b), g

    with mesh:
        (p1, _, m), g = jax.jit(both, in_shardings=(
            pspec, ospec, bspec(batch, mesh)))(
            jax.device_put(params, pspec), jax.device_put(state, ospec),
            batch)
    out = flat(p1, "p1", {})
    flat(g, "g", out)
    out["loss"] = np.float64(m["loss"])
    out["grad_norm"] = np.float64(m["grad_norm"])
    params = jax.device_put(params, pspec)
    pre = {k: jnp.asarray(v) for k, v in
           np.load(os.path.join(OUT, name + "_prefill.npz")).items()}
    with mesh:
        cache, logits = jax.jit(trainer.make_prefill_step(cfg, mesh, "flash"),
                                in_shardings=(pspec, bspec(pre, mesh)))(
            params, pre)
    flat(cache, "prefill_cache", out)
    out["prefill_logits"] = np.asarray(logits)
    cache = nest(dict(np.load(os.path.join(OUT, name + "_cache.npz"))), "c")
    cache["pos"] = cache["pos"].astype(jnp.int32)
    cspec = shardings_for(cache, mod.cache_specs(cfg), mesh)
    cache = jax.device_put(cache, cspec)
    toks = np.load(os.path.join(OUT, name + "_decode.npz"))["tokens"]
    dstep = trainer.make_decode_step(cfg, mesh, "flash")
    for i in range(toks.shape[0]):
        b = {"tokens": jnp.asarray(toks[i])}
        with mesh:
            logits, cache = jax.jit(dstep, in_shardings=(
                pspec, cspec, bspec(b, mesh)))(params, cache, b)
        # GSPMD may hand the cache back at another sharding
        cache = jax.device_put(cache, cspec)
        out[f"decode_logits{i}"] = np.asarray(logits)
    flat(cache, "decode_cache", out)
    np.savez(os.path.join(OUT, name + ".npz"), **out)
    print(name, float(m["loss"]), flush=True)
'''


def _rcfg(arch, over):
    return r_base.reduced_config(arch).with_(dtype="float32", **over)


def _inputs(d, name, cfg, rng):
    """The reference's parameters and AdamW state, a prompt, a decode
    cache (seeded values at ``init_cache``'s shapes, position ``POS``) and
    the decode tokens of one case, written to ``d``."""
    p, _ = r_api.init(cfg, jax.random.PRNGKey(0))
    s = r_opt.make_optimizer("adamw", lr=1e-3, warmup=1, total=10).init(p)
    np.savez(d / f"{name}_init.npz",
             **H.flatten(s, "s0", H.flatten(p, "p0", {})))
    np.savez(d / f"{name}_prefill.npz", tokens=rng.integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32))
    shapes = jax.eval_shape(
        lambda: r_api.module_for(cfg).init_cache(cfg, 2, MAX_SEQ))
    cache = jax.tree.map(
        lambda t: ((rng.standard_normal(t.shape) * 0.5).astype(np.float32)
                   if t.ndim else np.array(POS, dtype=np.int32)), shapes)
    np.savez(d / f"{name}_cache.npz", **H.flatten(cache, "c", {}))
    np.savez(d / f"{name}_decode.npz", tokens=rng.integers(
        0, cfg.vocab, (DECODE_STEPS, 2, 1)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' (1, 4) mesh steps of every case, started at once:
    (the reference's results by case, the port's rank-0 results)."""
    d = tmp_path_factory.mktemp("mesh_split")
    rng = np.random.default_rng(0)
    for name, arch, over in CASES:
        _inputs(d, name, _rcfg(arch, over), rng)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    refs = []
    for part in (CASES[0::2], CASES[1::2]):               # two compilers
        code = (f"SRC = {SRC!r}\nOUT = {str(d)!r}\nCASES = {part!r}\n"
                f"SHAPE = {SHAPE!r}\n" + REFERENCE)
        refs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        port = H.spawn("split_cases", 4, d / "port", timeout=300,
                       ref_dir=str(d), cases=CASES, shape=SHAPE)[0]
        outs = [ref.communicate(timeout=600) for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, (out, err) in zip(refs, outs):
        assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    refs = {name: dict(np.load(d / f"{name}.npz")) for name, *_ in CASES}
    inits = {name: dict(np.load(d / f"{name}_init.npz"))
             for name, *_ in CASES}
    return refs, inits, port


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_train_step_matches_the_reference_mesh_step(runs, case):
    """The loss and gradient norm within ``rtol 1e-5``; each parameter's
    change within ``2e-4 x`` the leaf's largest change wherever the
    reference's gradient is above ``1e-3 x`` the leaf's largest. (On
    this (1, 4) mesh the reference's zamba2 ``conv_bc`` gradient is its
    one-device one: C43's doubling shows on 2x2 only.)"""
    name = case[0]
    refs, inits, port = runs
    ref, init = refs[name], inits[name]
    grads = {k[1:]: v for k, v in ref.items() if k.startswith("g/")}
    gnorm = float(ref["grad_norm"])
    assert float(port[f"{name}/loss"]) == pytest.approx(float(ref["loss"]),
                                                        rel=LOSS_RTOL)
    assert float(port[f"{name}/grad_norm"]) == pytest.approx(gnorm,
                                                             rel=LOSS_RTOL)
    for k, r1 in ref.items():
        if not k.startswith("p1/"):
            continue
        leaf = k[2:]
        r0 = init["p0" + leaf]
        dr = r1 - r0
        dt = port[f"{name}/p1{leaf}"] - r0
        g = grads[leaf]
        live = np.abs(g) > 1e-3 * np.abs(g).max()
        scale = max(float(np.abs(dr).max()), 1e-30)
        np.testing.assert_allclose(dt[live], dr[live], rtol=0,
                                   atol=2e-4 * scale,
                                   err_msg=f"{name}{leaf}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_prefill_and_decode_match_the_reference_mesh_steps(runs,
                                                                 case):
    """Prefill logits and cache, both decode steps' logits and the cache
    after them, within ``1e-4 x`` the reference's largest value."""
    name = case[0]
    refs, _, port = runs
    ref = refs[name]
    keys = [k for k in ref if k.startswith(("prefill_", "decode_"))
            and k != "prefill_cache/pos"]
    assert any(k.startswith("decode_cache/") for k in keys)
    for k in keys:
        want, got = ref[k], port[f"{name}/{k}"]
        assert got.shape == want.shape, k
        if not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERVE_TOL * np.abs(want).max(),
                                   err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# compute specs against the reference's param_specs
# ---------------------------------------------------------------------------


def _tp_leaves(tree, path, out):
    """``path -> True`` for every leaf of a reference spec tree naming
    ``tp``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _tp_leaves(v, f"{path}/{k}", out)
    else:
        out[path] = any(e == "tp" or (isinstance(e, tuple) and "tp" in e)
                        for e in tree)
    return out


@pytest.mark.parametrize("shape,reduced", [((16, 16), False),
                                           ((1, 4), True)],
                         ids=["full-16x16", "reduced-1x4"])
def test_compute_specs_split_every_leaf_the_reference_splits(tmp_path,
                                                             shape,
                                                             reduced):
    """For every architecture, each leaf whose reference ``param_specs``
    name ``tp`` has a compute spec naming the tensor axis (or a ``Part``
    of it): no such leaf is computed whole."""
    got = H.spawn("split_specs", 1, tmp_path, timeout=120, group=False,
                  shape=shape, reduced=reduced)[0]
    for arch in ARCH_IDS:
        cfg = (r_base.reduced_config(arch) if reduced
               else r_base.get_config(arch))
        want = _tp_leaves(r_api.param_specs(cfg), arch, {})
        assert set(want) <= set(got), arch
        missed = [k for k, v in want.items() if v and not got[k]]
        assert not missed, missed


# ---------------------------------------------------------------------------
# the dry run of uneven splits
# ---------------------------------------------------------------------------

# a reduced dense config: 8 query heads in 2 kv groups, a vocab of 250
DRY = dict(arch="qwen2-0.5b", shape="train_4k", reduced=True,
           sizes=(32, 8), over={"n_heads": 8, "n_kv_heads": 2,
                                "vocab": 250})


def test_fake_trace_flops_fall_with_the_tensor_split(tmp_path):
    """A rank's traced FLOPs on a fake (1, 4) world within 1.3x of the
    (1, 1) trace's / 4 (the kv heads, fewer than the ranks, are computed
    on two ranks each; the dry run counts rank 0)."""
    one = H.spawn("dryrun_cell", 1, tmp_path / "one", timeout=120,
                  group=False, mesh=(1, 1), **DRY)[0]
    four = H.spawn("dryrun_cell", 1, tmp_path / "four", timeout=120,
                   group=False, mesh=(1, 4), **DRY)[0]
    assert 0 < four["flops"] <= 1.3 * one["flops"] / 4
    assert four["peak_bytes"] < one["peak_bytes"]


def test_a_fake_1x4_trace_of_uneven_splits_counts_what_the_gloo_step_runs(
        tmp_path):
    """The same cell with 6 query heads (3 a kv group over 2 ranks: 2 +
    1): traced on a fake (1, 4) world and run for real on four gloo ranks
    under the same counters. Rank 0's FLOPs, collective counts and bytes
    equal the trace's; every rank's collectives do."""
    cell = dict(DRY, over={"n_heads": 6, "n_kv_heads": 2, "vocab": 250})
    fake = H.spawn("dryrun_cell", 1, tmp_path / "fake", timeout=120,
                   group=False, mesh=(1, 4), **cell)[0]
    real = H.spawn("dryrun_real", 4, tmp_path / "real", timeout=120,
                   mesh=(1, 4), **cell)
    assert fake["counts/all-gather"] > 0 and fake["counts/all-reduce"] > 0
    for r, got in enumerate(real):
        for k, v in fake.items():
            if k == "peak_bytes" or (r and k == "flops"):
                continue
            assert got[k] == v, f"rank {r} {k}: {got[k]} against {v}"


# ---------------------------------------------------------------------------
# the blocks of a split, and the counts it refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_q,n_kv,n", [(14, 2, 16), (32, 8, 16), (56, 8, 16),
                                        (40, 40, 16), (6, 2, 4), (8, 8, 4),
                                        (5, 5, 2)])
def test_head_blocks_cover_every_head_once(n_q, n_kv, n):
    """Every query head is held by exactly one rank, within its kv
    group's ranks; every kv head by at least one; the even split is
    DTensor's chunk; rank 0 holds the most query heads."""
    from repro_torch.models.sharding import head_blocks

    blocks = [head_blocks(n_q, n_kv, n, r) for r in range(n)]
    held = sorted(h for (q0, q1), _ in blocks for h in range(q0, q1))
    assert held == list(range(n_q))
    assert {k for _, (k0, k1) in blocks for k in range(k0, k1)} == \
        set(range(n_kv))
    g = n_q // n_kv
    for (q0, q1), (k0, k1) in blocks:
        assert all(k0 <= h // g < k1 for h in range(q0, q1))
    assert blocks[0][0][1] - blocks[0][0][0] == max(b - a
                                                    for (a, b), _ in blocks)
    if n_kv % n == 0:
        assert [q for q, _ in blocks] == [(r * n_q // n, (r + 1) * n_q // n)
                                          for r in range(n)]


def test_splits_refuse_counts_they_cannot_take():
    """A count the tensor split cannot take raises, naming it: query heads
    that do not form the kv groups, MLA heads fewer than the ranks, a
    mamba inner dim (mamba1 channels, mamba2 heads) the ranks do not
    divide, a vocab smaller than the axis."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import mamba, sharding, transformer

    split = sharding.TensorSplit("model", 3, None, 0)
    with pytest.raises(ValueError, match="6 query heads do not form 4"):
        sharding.head_split(split, 6, 4)
    ssm = reduced_config("falcon-mamba-7b")
    with pytest.raises(ValueError, match="128 mamba1 inner channels"):
        mamba.inner_split(ssm, split)
    with pytest.raises(ValueError, match="8 mamba2 heads"):
        mamba.inner_split(reduced_config("zamba2-1.2b"), split)
    assert mamba.inner_split(ssm, sharding.TensorSplit("model", 4, None, 1))
    mla = reduced_config("minicpm3-4b")

    class FakeMesh:           # a mesh of a 8-way tensor axis, no groups
        axis_names, shape = ("data", "model"), {"data": 1, "model": 8}

        class device_mesh:
            @staticmethod
            def get_group(axis):
                return None

            @staticmethod
            def get_local_rank(axis):
                return 0

    with pytest.raises(ValueError, match="MLA's 4 heads"):
        transformer._splits(mla, FakeMesh)
    with pytest.raises(ValueError, match="a vocab of 4 "):
        sharding.vocab_split(FakeMesh, 4)
    attn, mlp, vocab = transformer._splits(
        reduced_config("qwen2-0.5b"), FakeMesh)
    assert (attn.q, attn.kv, attn.even) == ((0, 1), (0, 1), False)
    assert vocab.block == (0, 32) and mlp.n == 8
