"""Single-card training (ROADMAP A14a) against the reference: the mamba1
scan's backward, every family's ``loss_fn`` and its gradients, remat, the
train step, the kernels' grad guard (C40) and the launchers.

The reference's float32 parameters of each reduced config cross over by
``convert.params_from_reference``; the same numpy batch
(``data.pipeline.token_batch``, bit-equal in both packages) goes through
``jax.value_and_grad`` of the reference's ``loss_fn`` and through autograd
of the port's, on the CPU. ClusterKV runs the reference's XLA path
(``use_pallas=False``, what ``jax.grad`` differentiates) and, in the port,
B6's differentiable op with its plain forward and plain backward on the
CPU (the hand-written backward on the card); B1-B5 raise under grad where
they would launch a kernel (C40). Tolerances:

* the loss within ``rtol 1e-5``, every gradient leaf within ``1e-4 x`` the
  largest value of the reference's leaf (a whole model's float32 sums,
  forward and backward, in another order);
* the scan's backward: ``torch.autograd.gradcheck`` in float64, and
  ``1e-5 x scale`` against ``jax.grad`` of the reference's block;
* one train step: loss and gradient norm within ``rtol 1e-5``; each
  parameter's change within ``2e-4 x`` the leaf's largest change wherever
  the reference's gradient is above ``1e-3 x`` the leaf's largest (Adam
  divides a gradient by its own size, so where it is near zero float32
  noise sets the update's sign), ``2^-8 x`` with ``compress_grads``
  (one bf16 spacing of a microbatch's gradient); bf16 masters within one
  bf16 spacing.
"""
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tn

from repro.configs import base as r_base
from repro.configs.base import ClusterKVConfig as RCKV
from repro.data import pipeline as r_pipe
from repro.models import mamba as r_mb
from repro.models import model_api as r_api
from repro.models import transformer as r_tf
from repro.models.sharding import NO_SHARD
from repro.optim import optimizers as r_opt
from repro.train import trainer as r_tr
from repro_torch import convert as t_convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as t_base
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import train as t_launch
from repro_torch.models import mamba as t_mb
from repro_torch.models import model_api as t_api
from repro_torch.models import param as t_pm
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import trainer as t_tr

ROOT = Path(__file__).resolve().parents[1]
SEQ = 64
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BACKENDS = ("dense", "flash", "clusterkv")


def _rcfg(arch, **kw):
    ckv = RCKV(enabled=True, block_q=16, block_k=16, blocks_per_query=2,
               decode_clusters=2)
    return r_base.reduced_config(arch).with_(dtype="float32", clusterkv=ckv,
                                             **kw)


def _cross(rcfg, seed=0):
    rp, _ = r_api.init(rcfg, jax.random.PRNGKey(seed))
    tcfg = t_convert.config_from_reference(rcfg)
    tp = t_convert.params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), tcfg,
        device="cpu")
    return rp, tcfg, tp


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float()
    return {prefix: np.asarray(tn(tree), dtype=np.float64)}


def _port_grads(cfg, params, batch, backend):
    """(loss, gradient tree) of the port's ``loss_fn`` by autograd."""
    live = t_pm.tree_map(lambda t: t.detach().clone().requires_grad_(),
                         params)
    loss = t_api.module_for(cfg).loss_fn(live, cfg, batch, backend)
    grads = torch.autograd.grad(loss, t_pm.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return float(loss.detach()), t_pm.tree_map(lambda _: next(it), live)


def _assert_grads_close(port, ref, tol=GRAD_TOL):
    fp, fr = _flat(port), _flat(ref)
    assert set(fp) == set(fr)
    for k in fr:
        scale = max(float(np.abs(fr[k]).max()), 1e-30)
        np.testing.assert_allclose(fp[k], fr[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


def _batches(rcfg, b=2, s=SEQ, step=0):
    nb = r_pipe.token_batch(rcfg, step, b, s)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# ---------------------------------------------------------------------------
# the mamba1 scan under autograd (the repair this slice starts with)
# ---------------------------------------------------------------------------


def _scan_inputs(seed, b=2, s=11, di=3, n=4, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, di)).astype(dtype),
            (rng.random((b, s, di)) * 0.5 + 0.1).astype(dtype),
            (-rng.random((di, n)) - 0.2).astype(dtype),
            rng.standard_normal((b, s, n)).astype(dtype),
            rng.standard_normal((b, s, n)).astype(dtype))


@pytest.mark.parametrize("s,chunk", [(11, 4), (8, 8), (5, 16)])
def test_selective_scan_backward_passes_gradcheck(s, chunk):
    """The scan writes its chunk buffers in place, which autograd cannot
    follow (``addcmul(out=...)`` raised in backward); the differentiable
    path's adjoint passes gradcheck in float64, the last chunk padded, the
    final state an output too."""
    args = tuple(torch.from_numpy(a).requires_grad_()
                 for a in _scan_inputs(s, s=s))
    assert torch.autograd.gradcheck(
        lambda *t: t_mb.selective_scan(*t, chunk), args)


def test_selective_scan_values_do_not_depend_on_grad_mode():
    args = [torch.from_numpy(a) for a in _scan_inputs(1, s=37, di=8, n=16,
                                                      dtype=np.float32)]
    with torch.no_grad():
        y0, h0 = t_mb.selective_scan(*args, 16)
    y1, h1 = t_mb.selective_scan(*(a.clone().requires_grad_()
                                   for a in args), 16)
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())


def test_mamba1_block_gradients_match_jax_grad():
    """``jax.grad`` through the reference's ``mamba1_forward`` against
    autograd through the port's, float32, S spanning a padded chunk."""
    rcfg = _rcfg("falcon-mamba-7b")
    rp, tcfg, tp = _cross(rcfg)
    rlp = jax.tree.map(lambda a: a[0], rp["layers"]["mixer"])
    tlp = t_pm.tree_map(lambda a: a[0].clone().requires_grad_(),
                        tp["layers"]["mixer"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 37, rcfg.d_model)).astype(np.float32)
    wh = rng.standard_normal((2, rcfg.ssm.expand * rcfg.d_model,
                              rcfg.ssm.d_state)).astype(np.float32)
    rcfg = rcfg.with_(ssm=dataclasses.replace(rcfg.ssm, chunk=16))
    tcfg = tcfg.with_(ssm=dataclasses.replace(tcfg.ssm, chunk=16))

    def r_obj(lp, x):
        out, h, _ = r_mb.mamba1_forward(lp, x, rcfg, NO_SHARD)
        return jnp.sum(out * w) + jnp.sum(h * wh)

    rg_p, rg_x = jax.grad(r_obj, argnums=(0, 1))(rlp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, h, _ = t_mb.mamba1_forward(tlp, tx, tcfg)
    obj = (out * torch.from_numpy(w)).sum() + (h * torch.from_numpy(wh)).sum()
    leaves = t_pm.tree_leaves(tlp) + [tx]
    grads = torch.autograd.grad(obj, leaves)
    it = iter(grads)
    tg_p = t_pm.tree_map(lambda _: next(it), tlp)
    _assert_grads_close({"p": tg_p, "x": next(it)},
                        {"p": jax.tree.map(np.asarray, rg_p),
                         "x": np.asarray(rg_x)}, tol=1e-5)


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=r_base.ARCH_IDS)
def crossed(request):
    rcfg = _rcfg(request.param)
    return (rcfg,) + _cross(rcfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_gradients_match_the_reference(crossed, backend):
    rcfg, rp, tcfg, tp = crossed
    rb, tb = _batches(rcfg)
    rmod = r_api.module_for(rcfg)
    rl, rg = jax.value_and_grad(
        lambda p: rmod.loss_fn(p, rcfg, rb, NO_SHARD, backend))(rp)
    tl, tg = _port_grads(tcfg, tp, tb, backend)
    assert np.isfinite(tl)
    assert tl == pytest.approx(float(rl), rel=LOSS_RTOL)
    _assert_grads_close(tg, jax.tree.map(np.asarray, rg))


@pytest.mark.parametrize("chunk", [0, 32, 48])
def test_ce_loss_matches_the_reference(chunk):
    """Chunked (each chunk under a checkpoint) or whole; 48 does not
    divide the 128 tokens, so it takes the whole pass as the reference."""
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 64, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (2, 64)).astype(np.int32)
    rl, (rgh, rgw) = jax.value_and_grad(
        lambda h, w: r_tf.ce_loss(h, w, jnp.asarray(lab), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = t_tf.ce_loss(th, tw, torch.from_numpy(lab), chunk)
    gh, gw = torch.autograd.grad(tl, (th, tw))
    assert float(tl.detach()) == pytest.approx(float(rl), rel=LOSS_RTOL)
    _assert_grads_close({"h": gh, "w": gw},
                        {"h": np.asarray(rgh), "w": np.asarray(rgw)})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "whisper-medium"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(arch, policy):
    """Each layer under ``torch.utils.checkpoint`` (recomputed in backward;
    ``"dots"`` keeps the matmul outputs) against no remat: the same
    arithmetic, so equal values."""
    rcfg = _rcfg(arch)
    _, tcfg, tp = _cross(rcfg)
    _, tb = _batches(rcfg)
    l0, g0 = _port_grads(tcfg.with_(remat=False), tp, tb, "flash")
    l1, g1 = _port_grads(tcfg.with_(remat=True, remat_policy=policy), tp,
                         tb, "flash")
    assert l1 == l0
    _assert_grads_close(g1, g0, tol=1e-6)


def test_unstacked_layers_keep_one_gradient_buffer():
    """``param.unstack``: one UnbindBackward per leaf, so a stacked leaf's
    gradient is formed once, not as a zero stack per layer (the trap of
    indexing each layer under autograd)."""
    w = torch.randn(4, 3, 3, requires_grad=True)
    layers = t_pm.unstack({"w": w}, 4)
    loss = sum((lp["w"] ** 2).sum() for lp in layers)
    (g,) = torch.autograd.grad(loss, [w])
    assert torch.allclose(g, 2 * w)
    assert layers[1]["w"].grad_fn.name().startswith("Unbind")


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------


def _bf16_spacing(x):
    """The distance between adjacent bf16 values at each element's
    magnitude (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _assert_step_close(tp0, tp1, rp0, rp1, rgrads, bf16=False,
                       compressed=False):
    f0, f1 = _flat(tp0), _flat(tp1)
    r0, r1, rg = _flat(rp0), _flat(rp1), _flat(rgrads)
    for k in r0:
        if bf16:
            assert (np.abs(f1[k] - r1[k]) <= _bf16_spacing(r1[k])).all(), k
            continue
        dr, dt = r1[k] - r0[k], f1[k] - f0[k]
        live = np.abs(rg[k]) > 1e-3 * np.abs(rg[k]).max()
        scale = max(float(np.abs(dr).max()), 1e-30)
        # compressed: the accumulated gradient keeps one bf16 spacing of a
        # microbatch's gradient (its error feedback), which may be as
        # large as the leaf's largest
        np.testing.assert_allclose(
            dt[live], dr[live], rtol=0,
            atol=(2 ** -8 if compressed else 2e-4) * scale, err_msg=k)


@pytest.mark.parametrize("arch,name,mb,comp,pdt", [
    ("qwen2-0.5b", "adamw", 1, False, "float32"),
    ("qwen2-0.5b", "adamw", 4, False, "float32"),
    ("qwen2-0.5b", "adamw", 4, True, "float32"),
    ("qwen2-0.5b", "adafactor", 1, False, "float32"),
    ("qwen2-0.5b", "adafactor", 4, True, "float32"),
    ("falcon-mamba-7b", "adamw", 1, False, "float32"),
    ("mistral-large-123b", "adafactor", 1, False, "bfloat16")])
def test_train_step_matches_the_reference(arch, name, mb, comp, pdt):
    rcfg = _rcfg(arch, param_dtype=pdt)
    rp, tcfg, tp = _cross(rcfg)
    tp = t_pm.cast_tree(tp, t_pm.DTYPES[pdt])
    ropt = r_opt.make_optimizer(name, lr=1e-3, warmup=1, total=10)
    topt = t_opt.make_optimizer(name, lr=1e-3, warmup=1, total=10)
    rb, tb = _batches(rcfg, b=8, s=32)
    rstep, _ = r_tr.make_train_step(rcfg, None, "flash", microbatch=mb,
                                    compress_grads=comp, optimizer=ropt)
    tstep, opt = t_tr.make_train_step(tcfg, None, "flash", microbatch=mb,
                                      compress_grads=comp, optimizer=topt)
    assert opt is topt
    rgrads = jax.grad(lambda p: r_api.module_for(rcfg).loss_fn(
        p, rcfg, rb, NO_SHARD, "flash"))(rp)
    tp0 = t_pm.tree_map(lambda t: t.clone(), tp)
    rp1, rs1, rm = jax.jit(rstep)(rp, ropt.init(rp), rb)
    ts = topt.init(tp)
    tp1, ts1, tm = tstep(tp, ts, tb)
    assert tp1 is tp and ts1 is ts                    # updated in place
    assert int(ts["step"]) == 1
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                              rel=LOSS_RTOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=LOSS_RTOL)
    assert all(t.dtype == t_pm.DTYPES[pdt] and not t.requires_grad
               for t in t_pm.tree_leaves(tp))
    _assert_step_close(tp0, tp1, rp, rp1, rgrads, bf16=pdt == "bfloat16",
                       compressed=comp)


def test_microbatch_accumulation_matches_full_batch():
    """The reference's ``test_optim_trainer.py`` bounds, in the port."""
    cfg = t_base.reduced_config("qwen2-0.5b").with_(dtype="float32")
    params = t_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             t_pipe.token_batch(cfg, 0, 8, 32).items()}
    outs = {}
    for key, kw in (("full", {}), ("micro", {"microbatch": 4}),
                    ("comp", {"microbatch": 4, "compress_grads": True})):
        step, opt = t_tr.make_train_step(cfg, None, "flash", **kw)
        p = t_pm.tree_map(lambda t: t.clone(), params)
        outs[key] = step(p, opt.init(p), batch)
    (p1, _, m1), (p2, _, m2) = outs["full"], outs["micro"]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert max(float((a - b).abs().max()) for a, b in
               zip(t_pm.tree_leaves(p1), t_pm.tree_leaves(p2))) < 5e-3
    p3 = outs["comp"][0]
    rel = max(float((a - b).abs().max() / (a.abs().max() + 1e-9))
              for a, b in zip(t_pm.tree_leaves(p2), t_pm.tree_leaves(p3)))
    assert rel < 0.05


def test_train_step_decreases_loss():
    cfg = t_base.reduced_config("qwen2-0.5b")
    opt = t_opt.make_optimizer("adamw", lr=2e-3, warmup=2, total=40)
    step, _ = t_tr.make_train_step(cfg, None, "flash", optimizer=opt)
    params = t_api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    losses = []
    for s in range(25):
        batch = {k: torch.from_numpy(v)
                 for k, v in t_pipe.token_batch(cfg, s % 2, 4, 64).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_serving_steps_are_the_family_functions():
    """``make_prefill_step`` / ``make_decode_step`` give what the family's
    ``prefill`` / ``decode_step`` give."""
    rcfg = _rcfg("qwen2-0.5b")
    _, tcfg, tp = _cross(rcfg)
    _, tb = _batches(rcfg)
    pre = t_tr.make_prefill_step(tcfg, backend="clusterkv")
    dec = t_tr.make_decode_step(tcfg, backend="clusterkv")
    cache, logits = pre(tp, {"tokens": tb["tokens"]})
    c2, l2 = t_tf.prefill(tp, tcfg, {"tokens": tb["tokens"]}, "clusterkv")
    assert torch.equal(logits, l2)
    cache = t_api.grow_cache(tcfg, cache, SEQ + 16)
    nxt = logits.argmax(-1)[:, None]
    lg, _ = dec(tp, cache, {"tokens": nxt})
    c2 = t_api.grow_cache(tcfg, c2, SEQ + 16)
    lg2, _ = t_tf.decode_step(tp, tcfg, c2, nxt, "clusterkv")
    assert torch.equal(lg, lg2)


def test_training_on_a_mesh_raises_naming_a14b():
    """Training on a mesh (ROADMAP A14b) takes a process mesh: a
    single-controller ``Mesh`` (no ``device_mesh``, no process group) is
    refused, saying why. (The mesh step itself is held against the
    reference's in ``test_torch_mesh.py``.)"""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import P as t_shd_P

    cfg = t_base.reduced_config("qwen2-0.5b")
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    for m in (mesh, object()):
        with pytest.raises(ValueError, match="A14b.*process mesh"):
            t_tr.make_train_step(cfg, mesh=m)
    (pin, _, bin_), out = t_tr.train_shardings(
        cfg, mesh, t_opt.make_optimizer("adamw"),
        {"tokens": t_shd_P("dp", None)})
    assert bin_ == {"tokens": t_shd_P(("data",), None)}
    assert out[2] == {"loss": t_shd_P(), "grad_norm": t_shd_P()}
    assert pin["ln_f"]["scale"] == t_shd_P(None)


# ---------------------------------------------------------------------------
# C40: no kernel has a backward
# ---------------------------------------------------------------------------


def _guarded_calls():
    """One call of each kernel wrapper on small CPU inputs (the plain
    versions), by kernel name, and the tensor each takes that may require
    grad."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 32, 16, generator=g)
    k = torch.randn(1, 1, 32, 16, generator=g)
    v = torch.randn(1, 1, 32, 16, generator=g)
    pos = torch.arange(32, dtype=torch.int32)
    kpos = pos.expand(1, 1, 32)
    idx = torch.zeros(1, 1, 2, 1, dtype=torch.int32)
    cent = k.reshape(1, 1, 2, 16, 16).mean(3)
    vals = torch.randn(2, 1, 4, 4, generator=g)
    col = torch.zeros(2, 1, dtype=torch.int32)
    x = torch.randn(8, 3, generator=g)
    return {
        "B6": (q, lambda t: t_ops.block_attention(t, k, v, kpos, pos, idx,
                                                  bq=16, bk=16)),
        "B5": (q[:, :, 0], lambda t: t_ops.decode_attend_fused(
            t, k, v, kpos, cent, torch.tensor(31), n_sel=1, bk=16)),
        "B1": (x, lambda t: t_ops.bsr_spmv_batched(vals[None], col[None],
                                                  t[None])),
        "B2": (x, lambda t: t_ops.bsr_spmv(vals, col, t)),
        "B4": (x[:, :2].contiguous(), lambda t: t_ops.tsne_force(
            vals, col, t)),
        "B3": (torch.rand(4, generator=g), lambda t: t_ops.gamma_exact(
            np.arange(4), np.arange(4), 2.0, weights=t, device="cpu")),
    }


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5"])
def test_kernel_wrappers_raise_under_grad_where_they_launch(kernel,
                                                            monkeypatch):
    """C40: where a wrapper of B1-B5 launches its kernel (a CUDA tensor;
    emulated here by patching ``ops._launches_kernel``) it raises under
    grad mode with an input that requires grad, naming the kernel, rather
    than give an output whose gradient would be dropped; with grad mode
    off, or inputs that do not require grad, it runs (here the plain
    version). B6 has a backward and does not raise (below)."""
    t, call = _guarded_calls()[kernel]
    monkeypatch.setattr(t_ops, "_launches_kernel", lambda _: True)
    with pytest.raises(NotImplementedError, match=f"{kernel}.*C40"):
        call(t.clone().requires_grad_())
    with torch.no_grad():
        call(t.clone().requires_grad_())
    call(t)
    monkeypatch.undo()
    # on the CPU the plain version differentiates
    out = call(t.clone().requires_grad_())
    assert out.requires_grad


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ``repro_torch`` ops dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("repro_torch::"):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_clusterkv_train_step_differentiates_through_b6_where_it_launches(
        monkeypatch):
    """With the card emulated (``ops._launches_kernel`` patched, as for
    C40) a ClusterKV train step no longer raises at B6: each layer's
    attention runs B6's differentiable op and its backward op (their CPU
    implementations, the plain versions) once a step, remat recomputing
    the forward inside the backward; the step equals the step without
    the patch bit for bit."""
    rcfg = _rcfg("qwen2-0.5b")
    _, tcfg, tp = _cross(rcfg)
    tcfg = tcfg.with_(remat=True)
    _, tb = _batches(rcfg)
    step, opt = t_tr.make_train_step(tcfg, None, "clusterkv")
    p0 = t_pm.tree_map(lambda t: t.clone(), tp)
    _, _, want = step(p0, opt.init(p0), tb)
    monkeypatch.setattr(t_ops, "_launches_kernel", lambda _: True)
    with _OpLog() as log:
        _, _, got = step(tp, opt.init(tp), tb)
    n = tcfg.n_layers
    assert log.counts == {"repro_torch::block_attention_with_stats": 2 * n,
                          "repro_torch::block_attention_backward": n}
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for a, b in zip(t_pm.tree_leaves(tp), t_pm.tree_leaves(p0)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


def test_launch_train_restarts_from_its_checkpoint(tmp_path, capsys):
    """``launch.train`` under the Supervisor: a run of 8 steps saves at
    steps 3 and 7; with step 7's checkpoint removed, a second run resumes
    after step 3 and ends on step 7's parameters and optimizer state bit
    for bit."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "8", "--batch",
            "2", "--seq", "32", "--device", "cpu", "--ckpt-every", "4",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    first = t_launch.main(argv)
    ck = Checkpointer(tmp_path)
    assert ck.steps() == [3, 7]
    shutil.rmtree(tmp_path / "step_7")
    out = capsys.readouterr().out
    assert "resumed" not in out and "step     7 loss" in out
    second = t_launch.main(argv)
    out = capsys.readouterr().out
    assert "resumed from the checkpoint of step 3" in out
    assert "step     3 loss" not in out and "step     4 loss" in out
    a, b = _flat(first), _flat(second)      # keyed: a restored tree's
    assert set(a) == set(b)                 # dicts keep sorted key order
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_launch_train_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])


def test_train_lm_torch_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--steps", "40"], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK: trained through a simulated failure" in out.stdout
