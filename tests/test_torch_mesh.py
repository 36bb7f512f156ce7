"""Training on a mesh (ROADMAP A14b) against the reference's own mesh step.

The reference runs in a subprocess with four host devices on an auto-axis
``jax.sharding.Mesh`` of shape (2, 2) ("data", "model") (``jax.make_mesh``
gives explicit axes, under which its mesh step fails: ROADMAP C2), its
parameters, optimizer state and batch placed by ``shardings_for``, one
``jax.jit`` step. The port runs in four ``gloo`` processes on a (2, 2)
process mesh (``launch.mesh.make_test_mesh``), the same parameters and
state crossed over by ``convert.params_from_reference`` /
``opt_state_from_reference``, placed by ``train_shardings``'s specs, on the
same numpy batch (4 x 32 tokens). Every architecture's reduced config, in
float32, with AdamW (lr 1e-3, warmup 1; qwen also with Adafactor) under
the "2d" layout; granite also with ``expert_parallel=True`` (the
all-to-all path), under "2d" and under "moe_dp" (the batch over both
axes), and with 2 microbatches and ``compress_grads``. Both packages' runs start at once (the reference's
in two processes).

Tolerances, the single-card step tests' rule (``test_torch_train.py``):
the loss and the gradient norm within ``rtol 1e-5``; each parameter's
change within ``2e-4 x`` the leaf's largest change wherever the
reference's gradient (under the same mesh) is above ``1e-3 x`` the leaf's
largest, ``2^-8 x`` with ``compress_grads``.

One departure is the reference's (ROADMAP C43): on the mesh it doubles
zamba2's ``conv_bc`` weight gradient (its single-device gradient and the
port's agree). The test pins the factor, and holds the port's gradient
norm and that leaf's change against the reference's step on one device.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_harness as H

from repro.configs import base as r_base
from repro.models import model_api as r_api
from repro.models import sharding as r_shd
from repro.optim import optimizers as r_opt
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import base as t_base
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import model_api as t_api
from repro_torch.models import moe as t_moe
from repro_torch.models import sharding as t_shd
from repro_torch.models.sharding import P
from repro_torch.optim import optimizers as t_opt

SRC = str(Path(__file__).resolve().parents[1] / "src")
GRANITE = "granite-moe-3b-a800m"
# (name, arch, expert_parallel, microbatch, compress_grads, optimizer,
# layout); every reduced config trains with AdamW under "2d", Adafactor
# once, the "moe_dp" layout (batch over both axes, experts over "model")
# once
CASES = [(a, a, False, 1, False, "adamw", "2d") for a in ARCH_IDS] + [
    ("granite-ep", GRANITE, True, 1, False, "adamw", "2d"),
    ("granite-mb2-compressed", GRANITE, False, 2, True, "adamw", "2d"),
    ("qwen2-0.5b-adafactor", "qwen2-0.5b", False, 1, False, "adafactor",
     "2d"),
    ("granite-ep-moe_dp", GRANITE, True, 1, False, "adamw", "moe_dp")]
LOSS_RTOL = 1e-5
# architectures whose reference step also runs on one device (C43)
SINGLE_TOO = ("zamba2-1.2b",)

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC)
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import base
from repro.data import pipeline
from repro.models import model_api
from repro.models.sharding import ShardCtx, set_layout, shardings_for
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

assert jax.device_count() == 4
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for name, arch, ep, mb, comp, opt_name, layout in CASES:
    set_layout(layout)
    cfg = base.reduced_config(arch).with_(dtype="float32")
    if ep:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True))
    opt = make_optimizer(opt_name, lr=1e-3, warmup=1, total=10)
    step, _ = trainer.make_train_step(cfg, mesh, "flash", microbatch=mb,
                                      compress_grads=comp, optimizer=opt)
    init = dict(np.load(os.path.join(OUT, name + "_init.npz")))
    params, state = nest(init, "p0"), nest(init, "s0")
    state["step"] = state["step"].astype(jnp.int32)
    specs = model_api.param_specs(cfg)
    pspec = shardings_for(params, specs, mesh)
    ospec = shardings_for(state, opt.state_specs(specs), mesh)
    batch = {k: jnp.asarray(v) for k, v in
             pipeline.token_batch(cfg, 0, 4, 32).items()}
    bspec = shardings_for(batch, {k: P("dp", *([None] * (v.ndim - 1)))
                                  for k, v in batch.items()}, mesh)
    params = jax.device_put(params, pspec)
    state = jax.device_put(state, ospec)
    batch = jax.device_put(batch, bspec)
    mod = model_api.module_for(cfg)

    def both(p, s, b):
        g = jax.grad(lambda q: mod.loss_fn(q, cfg, b, ShardCtx(mesh),
                                           "flash"))(p)
        return step(p, s, b), g

    with mesh:
        (p1, s1, m), g = jax.jit(both, in_shardings=(pspec, ospec, bspec))(
            params, state, batch)
    out = flat(p1, "p1", {})
    flat(g, "g", out)
    out["loss"] = np.float64(m["loss"])
    out["grad_norm"] = np.float64(m["grad_norm"])
    if arch in SINGLE_TOO:
        # the same step on one device (ROADMAP C43)
        step1, _ = trainer.make_train_step(cfg, None, "flash", microbatch=mb,
                                           compress_grads=comp, optimizer=opt)
        params, state = nest(init, "p0"), nest(init, "s0")
        state["step"] = state["step"].astype(jnp.int32)
        batch = {k: jnp.asarray(v) for k, v in
                 pipeline.token_batch(cfg, 0, 4, 32).items()}
        p1, _, m = jax.jit(step1)(params, state, batch)
        g = jax.jit(jax.grad(lambda q: mod.loss_fn(q, cfg, batch,
                                                   ShardCtx(None), "flash")))(
            params)
        flat(p1, "single/p1", out)
        flat(g, "single/g", out)
        out["single/grad_norm"] = np.float64(m["grad_norm"])
    np.savez(os.path.join(OUT, name + ".npz"), **out)
    print(name, float(m["loss"]), flush=True)
set_layout("2d")

if MOE_FFN:
    # granite's layer-0 FFN under the mesh, both splits (moe_ffn.npz)
    from repro.models import moe as moe_mod
    cfg = base.reduced_config("granite-moe-3b-a800m").with_(dtype="float32")
    init = dict(np.load(os.path.join(OUT, "granite-moe-3b-a800m_init.npz")))
    ffn = {k[len("p0/layers/ffn/"):]: v[0] for k, v in init.items()
           if k.startswith("p0/layers/ffn/")}
    ffn = nest({"f/" + k: v for k, v in ffn.items()}, "f")
    x = jnp.asarray(np.load(os.path.join(OUT, "moe_x.npy")))
    out = {}
    for ep in (False, True):
        c = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=ep))
        y, aux = moe_mod.moe_ffn(ffn, x, c, ShardCtx(mesh))
        out[f"y_{ep}"], out[f"aux_{ep}"] = np.asarray(y), np.asarray(aux)
    np.savez(os.path.join(OUT, "moe_ffn.npz"), **out)
'''


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _rcfg(arch, ep):
    cfg = r_base.reduced_config(arch).with_(dtype="float32")
    if ep:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True))
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' mesh steps of every case, started at once: (the
    reference's results by case, the port's rank-0 results)."""
    d = tmp_path_factory.mktemp("mesh_step")
    for name, arch, ep, _, _, opt_name, _ in CASES:
        p, _ = r_api.init(_rcfg(arch, ep), jax.random.PRNGKey(0))
        s = r_opt.make_optimizer(opt_name, lr=1e-3, warmup=1,
                                 total=10).init(p)
        np.savez(d / f"{name}_init.npz", **_flat(s, "s0", _flat(p, "p0", {})))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    refs = []
    np.save(d / "moe_x.npy", np.random.default_rng(0).standard_normal(
        (4, 16, r_base.reduced_config(GRANITE).d_model)).astype(np.float32))
    for i, part in enumerate((CASES[0::2], CASES[1::2])):  # two compilers
        code = (f"SRC = {SRC!r}\nOUT = {str(d)!r}\nCASES = {part!r}\n"
                f"SINGLE_TOO = {SINGLE_TOO!r}\nMOE_FFN = {i == 0}\n"
                + REFERENCE)
        refs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        port = H.spawn("train_cases", 4, d / "port", timeout=600,
                       ref_dir=str(d), cases=CASES)[0]
        outs = [ref.communicate(timeout=900) for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, (out, err) in zip(refs, outs):
        assert ref.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    refs = {name: dict(np.load(d / f"{name}.npz")) for name, *_ in CASES}
    refs["moe_ffn"] = dict(np.load(d / "moe_ffn.npz"))
    refs["moe_x"] = np.load(d / "moe_x.npy")
    inits = {name: dict(np.load(d / f"{name}_init.npz")) for name, *_ in CASES}
    return refs, inits, port


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_step_matches_the_reference_mesh_step(runs, case):
    name, arch, ep, mb, comp, _, _ = case
    refs, inits, port = runs
    ref, init = refs[name], inits[name]
    grads = {k[1:]: v for k, v in ref.items() if k.startswith("g/")}
    gnorm = float(ref["grad_norm"])
    if arch in SINGLE_TOO:
        # C43: the reference's mesh step doubles this leaf's gradient; the
        # leaf and the norm are held against its step on one device
        key = "/layers/mixer/conv_bc/w"
        single = ref["single/g" + key]
        np.testing.assert_allclose(grads[key], 2 * single, rtol=0,
                                   atol=1e-4 * np.abs(single).max())
        grads[key] = ref["single/g" + key]
        ref = dict(ref)
        ref["p1" + key] = ref["single/p1" + key]
        gnorm = float(ref["single/grad_norm"])
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
                                   atol=(2 ** -8 if comp else 2e-4) * scale,
                                   err_msg=f"{name}{leaf}")
    assert int(port[f"{name}/s1/step"]) == 1


# ---------------------------------------------------------------------------
# the spec trees
# ---------------------------------------------------------------------------


def _tuples(tree):
    """A reference spec tree (``PartitionSpec`` leaves) as nested dicts of
    tuples; the port's ``P`` leaves likewise."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _cfgs(arch):
    return [(r_base.get_config(arch), t_base.get_config(arch)),
            (r_base.reduced_config(arch), t_base.reduced_config(arch))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch):
    """``param_specs``, ``cache_specs`` (both context lengths),
    ``input_specs`` / ``cache_shapes`` of every shape cell and the two
    optimizers' ``state_specs``, full and reduced config."""
    for rcfg, tcfg in _cfgs(arch):
        for ep in (False, True):
            if ep and rcfg.moe is None:
                continue
            if ep:
                rcfg = rcfg.with_(moe=dataclasses.replace(
                    rcfg.moe, expert_parallel=True))
                tcfg = tcfg.with_(moe=dataclasses.replace(
                    tcfg.moe, expert_parallel=True))
            rspec = r_api.param_specs(rcfg)
            tspec = t_api.param_specs(tcfg)
            assert _tuples(tspec) == _tuples(rspec)
            for name in ("adamw", "adafactor"):
                assert _tuples(t_opt.make_optimizer(name).state_specs(tspec)) \
                    == _tuples(r_opt.make_optimizer(name).state_specs(rspec))
        for long_ctx in (False, True):
            assert _tuples(t_api.module_for(tcfg).cache_specs(tcfg, long_ctx)) \
                == _tuples(r_api.module_for(rcfg).cache_specs(rcfg, long_ctx))
    rcfg, tcfg = _cfgs(arch)[0]
    for shape_name, (_, _, kind) in t_base.SHAPES.items():
        rs, rp = r_api.input_specs(rcfg, shape_name)
        ts, tp = t_api.input_specs(tcfg, shape_name)
        assert _tuples(tp) == _tuples(rp)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in ts.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in rs.items()}
        assert all(v.device.type == "meta" for v in ts.values())
        if kind != "decode":
            continue
        rsh, rsp = r_api.cache_shapes(rcfg, shape_name)
        tsh, tsp = t_api.cache_shapes(tcfg, shape_name)
        assert _tuples(tsp) == _tuples(rsp)
        assert jax.tree.map(lambda a: tuple(a.shape), rsh) == \
            t_base_shapes(tsh)


def t_base_shapes(tree):
    if isinstance(tree, dict):
        return {k: t_base_shapes(v) for k, v in tree.items()}
    assert tree.device.type == "meta"
    return tuple(tree.shape)


def _meshes():
    """A single-controller (2, 2) mesh of the port (fit_spec and
    placements read its axes only) and the reference's."""
    from jax.sharding import AbstractMesh

    return (make_mesh((2, 2), ("data", "model"), ["cpu"] * 4),
            AbstractMesh((2, 2), ("data", "model")))


def test_layouts_resolve_and_fit_as_the_reference():
    """``tests/test_dryrun_roofline.py``'s cases, and every layout's
    resolution of every token on a 2- and a 3-axis mesh."""
    assert t_shd.LAYOUTS == r_shd.LAYOUTS
    tmesh, _ = _meshes()
    cases = [((3, 8), P("data", ("data", "model")), P(None, ("data", "model"))),
             ((2, 8), P("data", ("data", "model")), P("data", "model")),
             ((4, 6), P(("data", "model"), None), P(("data", "model"), None)),
             ((2, 6), P(("data", "model"), None), P("data", None)),
             ((8,), P("data"), P("data"))]
    for dims, spec, want in cases:
        assert t_shd.fit_spec(dims, spec, tmesh) == want
    try:
        t_shd.set_layout("dp_all")
        assert t_shd.resolve_spec(P("tp"), tmesh) == P(None)
        assert t_shd.resolve_spec(P("dp"), tmesh) == P(("data", "model"))
        t_shd.set_layout("2d")
        assert t_shd.resolve_spec(P("tp"), tmesh) == P("model")
        assert t_shd.resolve_spec(P("fsdp"), tmesh) == P(("data",))
        with pytest.raises(KeyError):
            t_shd.set_layout("nope")
    finally:
        t_shd.set_layout("2d")
    axes3 = ("pod", "data", "model")
    for layout in t_shd.LAYOUTS:
        for axes in (("data", "model"), axes3):
            t_shd.set_layout(layout)
            r_shd.set_layout(layout)
            try:
                for tok in t_shd.TOKEN_AXES + ("model", (("dp", "tp"))):
                    assert t_shd._resolve_token(tok, axes) == \
                        r_shd._resolve_token(tok, axes)
            finally:
                t_shd.set_layout("2d")
                r_shd.set_layout("2d")


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    tmesh, _ = _meshes()
    sh = t_shd.NamedSharding(tmesh, P(None, ("data", "model")))
    assert t_shd.placements(sh) == (Shard(1), Shard(1))
    sh = t_shd.NamedSharding(tmesh, P("model", "data"))
    assert t_shd.placements(sh) == (Shard(1), Shard(0))
    assert t_shd.placements(t_shd.NamedSharding(tmesh, P())) == \
        (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's axis order"):
        t_shd.placements(t_shd.NamedSharding(tmesh, P(("model", "data"))))
    # shardings_for fits each leaf's shape, as the reference's
    tree = {"w": torch.empty(3, 8, device="meta"), "b": torch.empty(4)}
    got = t_shd.shardings_for(tree, {"w": P("fsdp", "tp"), "b": P("tp")},
                              tmesh)
    assert got["w"].spec == P(None, "model") and got["b"].spec == P("model")
    tree = t_shd.resolve_tree({"w": P("fsdp", "tp")}, tmesh)
    assert tree["w"] == t_shd.NamedSharding(tmesh, P(("data",), "model"))


def test_process_meshes_need_a_process_group():
    """Without an initialized process group (or with too few ranks) a
    process mesh raises, as ``jax.make_mesh`` does without devices; the
    MoE FFN's split under a (2, 2) mesh."""
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(2, 2, device="cpu")
    cfg = t_base.reduced_config(GRANITE).with_(dtype="float32")
    tmesh, _ = _meshes()
    assert tmesh.device_mesh is None
    assert t_moe.mesh_branch(cfg, tmesh, 32) == "tp"
    ep = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True))
    assert t_moe.mesh_branch(ep, tmesh, 32) == "ep"
    assert t_moe.mesh_branch(ep, tmesh, 31) == "tp"    # seq does not split


@pytest.mark.parametrize("ep", [False, True], ids=["expert-tp", "ep"])
def test_moe_ffn_on_a_single_controller_mesh_matches_the_reference(runs, ep):
    """granite's layer-0 FFN under a single-controller (2, 2) mesh (the
    shards routed one after another in one process) against the
    reference's ``moe_ffn`` on its 2x2 mesh: per-shard capacity, the aux
    loss over the whole batch; within ``1e-5 x`` the output's scale."""
    from repro_torch import convert

    refs, inits, _ = runs
    cfg = t_base.reduced_config(GRANITE).with_(
        dtype="float32", moe=dataclasses.replace(
            t_base.reduced_config(GRANITE).moe, expert_parallel=ep))
    params = convert.params_from_reference(
        H.nest(inits[GRANITE], "p0"), cfg, "cpu")
    ffn = {k: (v[0] if isinstance(v, torch.Tensor) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in params["layers"]["ffn"].items()}
    tmesh, _ = _meshes()
    y, aux = t_moe.moe_ffn(ffn, torch.from_numpy(refs["moe_x"]), cfg,
                           t_shd.ShardCtx(tmesh))
    want = refs["moe_ffn"][f"y_{ep}"]
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert float(aux) == pytest.approx(float(refs["moe_ffn"][f"aux_{ep}"]),
                                       rel=1e-6)


# ---------------------------------------------------------------------------
# Adafactor on each rank's shards
# ---------------------------------------------------------------------------

# (shape, physical spec on the (2, 2) mesh): a stacked layer leaf split over
# both axes, a matrix split on its rows only and on both dims over both
# axes, a vector
ADAFACTOR_LEAVES = {
    "stacked": ((3, 8, 16), (None, "data", "model")),
    "rows": ((8, 12), ("model", None)),
    "both-axes": ((8, 16), (None, ("data", "model"))),
    "vector": ((16,), (("data", "model"),)),
}


def test_adafactor_updates_each_leaf_on_its_shards(tmp_path):
    """One Adafactor update on a (2, 2) mesh equals the update of the whole
    leaf (parameter, ``vr``/``vc`` or ``v``, and the gradient norm) within
    ``rtol 1e-6``, and no op makes a tensor larger than the parameter's
    float32 shard on any rank: the factored statistics and the update's
    RMS are all-reduced sums, and no leaf is gathered."""
    res = H.spawn("adafactor_leaves", 4, tmp_path / "ranks", timeout=120,
                  leaves=ADAFACTOR_LEAVES)
    for name, (shape, _) in ADAFACTOR_LEAVES.items():
        for got in res:
            for k in [k for k in got if k.startswith(f"{name}/mesh")]:
                want = got[k.replace("/mesh", "/whole")]
                np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=k)
            norm, want_norm = got[f"{name}/norm"]
            assert norm == pytest.approx(want_norm, rel=1e-6)
            shard = int(got[f"{name}/shard_numel"])
            assert shard < np.prod(shape), name
            assert int(got[f"{name}/most_bytes"]) <= 4 * shard, name


# ---------------------------------------------------------------------------
# checkpoint reshard and the launcher, on four gloo ranks
# ---------------------------------------------------------------------------


def test_elastic_checkpoint_reshard(tmp_path):
    """Saved from a 4-way ("data",) mesh, restored onto (2, 2): every
    rank's shard is its block of the saved array, as the reference's
    ``test_elastic_checkpoint_reshard`` (and, in the job, DTensor's own
    split, for a dim split over both axes, a bf16 stack saved in runs and
    a scalar too)."""
    res = H.spawn("reshard", 4, tmp_path / "ranks", timeout=120,
                  ckpt_dir=str(tmp_path / "ckpt"))
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    v = np.arange(64.0, dtype=np.float32).reshape(16, 4)
    for r, got in enumerate(res):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(got["local/w"],
                                      w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(got["local/v"], v[4 * r:4 * r + 4])
        assert tuple(got["mesh"]) == (2, 2)


def test_launch_train_on_a_mesh_restarts_resharded(tmp_path):
    """``launch.train --mesh 2,2 --device cpu``: 6 steps saving at 2 and 5;
    with step 5's checkpoint removed a second run restores step 2's onto
    the mesh and ends on the first run's parameters bit for bit."""
    res = H.spawn("launch_restart", 4, tmp_path / "ranks", timeout=300,
                  ckpt_dir=str(tmp_path / "ckpt"))
    out = res[0]
    assert int(out["resumed_at"]) == 2
    keys = [k for k in out if k.startswith("first/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(out["second/" + k[6:]], out[k],
                                      err_msg=k)
