"""Serving on a process mesh (ROADMAP A15's gap): ``make_prefill_step(mesh=)``
and ``make_decode_step(mesh=, sharded_long=)`` of one reduced config per
family (dense, vlm, moe, ssm, hybrid, encdec, and MLA), in float32, on a
(2, 2) ("data", "model") ``gloo`` mesh (``_torch_mesh_harness.serve_cases``),
against the reference's steps jitted on its 2x2 auto-axis mesh
(``jax.sharding.Mesh``: its ``jax.make_mesh`` meshes fail, ROADMAP C2) in
two subprocesses, on the same parameters (crossed over by
``convert.params_from_reference``), prompts, caches and tokens. One decode
is the sharded long-context ClusterKV decode (batch 1, the cache sequence
split over "data", each rank's slice attended on its own and the partials
combined). Logits and caches within ``1e-4 x`` the reference's largest
logit or cache entry, as the serving tests hold a step
(``test_torch_serve.py``). The dry run (``test_torch_dryrun.py``) traces
these steps.
"""
import dataclasses
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

SRC = str(Path(__file__).resolve().parents[1] / "src")
CKV = {"block_q": 8, "block_k": 8, "decode_clusters": 2}
# (name, arch, ClusterKV overrides, backend, sharded_long)
SERVE_CASES = [
    ("qwen2-0.5b", "qwen2-0.5b", None, "flash", False),
    ("qwen2-0.5b-long", "qwen2-0.5b", CKV, "clusterkv", True),
    ("llava-next-34b", "llava-next-34b", None, "flash", False),
    ("granite-moe-3b-a800m", "granite-moe-3b-a800m", None, "flash", False),
    ("minicpm3-4b", "minicpm3-4b", None, "flash", False),
    ("falcon-mamba-7b", "falcon-mamba-7b", None, "flash", False),
    ("zamba2-1.2b", "zamba2-1.2b", None, "flash", False),
    ("whisper-medium", "whisper-medium", None, "flash", False)]
PROMPT, MAX_SEQ, POS, DECODE_STEPS = 32, 64, 40, 2
SERVE_TOL = 1e-4

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC)
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import base
from repro.models import model_api
from repro.models.sharding import shardings_for
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

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for name, arch, ckv, backend, long_ctx in CASES:
    cfg = base.reduced_config(arch).with_(dtype="float32")
    if ckv:
        cfg = cfg.with_(clusterkv=dataclasses.replace(cfg.clusterkv,
                                                      enabled=True, **ckv))
    mod = model_api.module_for(cfg)
    params = nest(dict(np.load(os.path.join(OUT, name + "_init.npz"))), "p0")
    pspec = shardings_for(params, model_api.param_specs(cfg), mesh)
    params = jax.device_put(params, pspec)

    def bspec(b):
        return shardings_for(b, {k: P("dp", *([None] * (v.ndim - 1)))
                                 for k, v in b.items()}, mesh)
    pre = {k: jnp.asarray(v) for k, v in
           np.load(os.path.join(OUT, name + "_prefill.npz")).items()}
    out = {}
    with mesh:
        cache, logits = jax.jit(trainer.make_prefill_step(cfg, mesh, backend),
                                in_shardings=(pspec, bspec(pre)))(params, pre)
    flat(cache, "prefill_cache", out)
    out["prefill_logits"] = np.asarray(logits)
    cache = nest(dict(np.load(os.path.join(OUT, name + "_cache.npz"))), "c")
    cache["pos"] = cache["pos"].astype(jnp.int32)
    cspec = shardings_for(cache, mod.cache_specs(cfg, long_ctx), mesh)
    cache = jax.device_put(cache, cspec)
    toks = np.load(os.path.join(OUT, name + "_decode.npz"))["tokens"]
    step = trainer.make_decode_step(cfg, mesh, backend, sharded_long=long_ctx)
    for i in range(toks.shape[0]):
        b = {"tokens": jnp.asarray(toks[i])}
        with mesh:
            logits, cache = jax.jit(step, in_shardings=(pspec, cspec,
                                                        bspec(b)))(
                params, cache, b)
        out[f"decode_logits{i}"] = np.asarray(logits)
    flat(cache, "decode_cache", out)
    np.savez(os.path.join(OUT, name + ".npz"), **out)
    print(name, flush=True)
'''


def _rcfg(arch, ckv):
    cfg = r_base.reduced_config(arch).with_(dtype="float32")
    if ckv:
        cfg = cfg.with_(clusterkv=dataclasses.replace(cfg.clusterkv,
                                                      enabled=True, **ckv))
    return cfg


def _serve_inputs(d, name, cfg, long_ctx, rng):
    """The reference's parameters, a prompt, a decode cache (seeded
    values at ``init_cache``'s shapes, position ``POS``) and the decode
    tokens of one case, written to ``d``."""
    p, _ = r_api.init(cfg, jax.random.PRNGKey(0))
    np.savez(d / f"{name}_init.npz", **H.flatten(p, "p0", {}))
    b = 1 if long_ctx else 2
    pre = {}
    if cfg.family == "vlm":
        pre["embeddings"] = rng.standard_normal(
            (b, PROMPT, cfg.d_model)).astype(np.float32)
    else:
        if cfg.family == "encdec":
            pre["frames"] = rng.standard_normal(
                (b, PROMPT, cfg.d_model)).astype(np.float32)
        pre["tokens"] = rng.integers(0, cfg.vocab, (b, PROMPT)).astype(
            np.int32)
    np.savez(d / f"{name}_prefill.npz", **pre)
    shapes = jax.eval_shape(
        lambda: r_api.module_for(cfg).init_cache(cfg, b, MAX_SEQ))
    cache = jax.tree.map(
        lambda s: ((rng.standard_normal(s.shape) * 0.5).astype(np.float32)
                   if s.ndim else np.array(POS, dtype=np.int32)), shapes)
    np.savez(d / f"{name}_cache.npz", **H.flatten(cache, "c", {}))
    if cfg.family == "vlm":
        toks = rng.standard_normal((DECODE_STEPS, b, 1, cfg.d_model))
        toks = toks.astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab, (DECODE_STEPS, b, 1)).astype(
            np.int32)
    np.savez(d / f"{name}_decode.npz", tokens=toks)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Both packages' mesh prefill and decode of every case, started at
    once: (the reference's results by case, the port's rank-0 results)."""
    d = tmp_path_factory.mktemp("mesh_serve")
    rng = np.random.default_rng(0)
    for name, arch, ckv, _, long_ctx in SERVE_CASES:
        _serve_inputs(d, name, _rcfg(arch, ckv), long_ctx, rng)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    refs = []
    for part in (SERVE_CASES[0::2], SERVE_CASES[1::2]):    # two compilers
        code = (f"SRC = {SRC!r}\nOUT = {str(d)!r}\nCASES = {part!r}\n"
                + REFERENCE)
        refs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        port = H.spawn("serve_cases", 4, d / "port", timeout=300,
                       ref_dir=str(d), cases=SERVE_CASES)[0]
        outs = [ref.communicate(timeout=600) for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, (out, err) in zip(refs, outs):
        assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return {name: dict(np.load(d / f"{name}.npz"))
            for name, *_ in SERVE_CASES}, port


@pytest.mark.parametrize("case", SERVE_CASES, ids=[c[0] for c in SERVE_CASES])
def test_mesh_prefill_and_decode_match_the_reference_mesh_steps(serve_runs,
                                                               case):
    """Prefill logits and cache, both decode steps' logits and the cache
    after them, on the 2x2 process mesh against the reference's 2x2 mesh
    steps, within ``SERVE_TOL x`` the reference's largest value."""
    name = case[0]
    refs, port = serve_runs
    ref = refs[name]
    keys = [k for k in ref if k != "prefill_cache/pos"]
    assert any(k.startswith("decode_cache/") for k in keys)
    for k in keys:
        want = ref[k]
        got = port[f"{name}/{k}"]
        assert got.shape == want.shape, k
        if not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERVE_TOL * np.abs(want).max(),
                                   err_msg=f"{name} {k}")
