"""The optimizers, the token pipeline, the fault-tolerance supervisor and
the analytic FLOP/byte model (ROADMAP A14a) against the reference.

The same numpy inputs go through both packages on the CPU. Tolerances:

* ``warmup_cosine``: ``rtol 1e-6`` (the same float32 arithmetic; ``cos``
  and ``pow`` from two math libraries);
* ``global_norm``: ``rtol 1e-6`` (float32 sums of squares in another
  order);
* one and five ``AdamW`` / ``Adafactor`` updates fed the same gradients:
  parameters and state within ``rtol 1e-6`` of each leaf's largest value
  (``atol 1e-6 x max|leaf|``), ``step`` exactly;
* ``token_batch``: bit-equal; the analytic model's FLOPs and bytes:
  exactly equal (the same Python arithmetic on the same parameter counts).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tn

from repro.configs import base as r_base
from repro.data import pipeline as r_pipe
from repro.launch import analytic as r_an
from repro.launch import ft as r_ft
from repro.optim import optimizers as r_opt
from repro_torch import convert as t_convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as t_base
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import analytic as t_an
from repro_torch.launch.ft import StepTimeout, Supervisor
from repro_torch.models import param as t_pm
from repro_torch.optim import optimizers as t_opt

RTOL = 1e-6


def _flat(tree, prefix=""):
    """{key path: float64 numpy array} of a nested dict of arrays or
    tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tn(tree), dtype=np.float64)}


def _close_trees(port, ref, rtol=RTOL):
    fp, fr = _flat(port), _flat(ref)
    assert set(fp) == set(fr)
    for k in fr:
        scale = max(float(np.abs(fr[k]).max()), 1e-30)
        np.testing.assert_allclose(fp[k], fr[k], rtol=0, atol=rtol * scale,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# schedule, norms, optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 6), (100, 10_000)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    ref = np.asarray(r_opt.warmup_cosine(3e-4, warmup, total)(
        jnp.asarray(steps)))
    got = tn(t_opt.warmup_cosine(3e-4, warmup, total)(
        torch.from_numpy(steps)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_schedule_warmup_and_decay():
    lr = t_opt.warmup_cosine(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) < 2e-4
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=0.1)
    assert float(lr(torch.tensor(99))) < 3e-4


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 6, 8)).astype(np.float32),
            "emb": {"table": rng.standard_normal((16, 8)).astype(np.float32)
                    * 3.0},
            "b": rng.standard_normal((8,)).astype(np.float32) * 1e-3}


def test_global_norm_and_clip_match_the_reference():
    g = _grad_tree(0)
    rn = float(r_opt.global_norm(jax.tree.map(jnp.asarray, g)))
    tg = t_pm.tree_map(torch.from_numpy, g)
    assert float(t_opt.global_norm(tg)) == pytest.approx(rn, rel=RTOL)
    rc, rnorm = r_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tnorm = t_opt.clip_by_global_norm(tg, 1.0)
    assert float(tnorm) == pytest.approx(float(rnorm), rel=RTOL)
    _close_trees(tc, jax.tree.map(np.asarray, rc))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_updates", [1, 5])
def test_optimizer_updates_match_the_reference(name, n_updates):
    """The same parameters and, at each update, the same gradients: the
    port's params and state after ``n_updates`` equal the reference's."""
    params = _grad_tree(100)
    ropt = r_opt.make_optimizer(name, lr=1e-2, warmup=2, total=20)
    topt = t_opt.make_optimizer(name, lr=1e-2, warmup=2, total=20)
    rp = jax.tree.map(jnp.asarray, params)
    tp = t_pm.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    rs, ts = ropt.init(rp), topt.init(tp)
    for i in range(n_updates):
        g = _grad_tree(i + 1)
        rp, rs, rnorm = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp2, ts2, tnorm = topt.update(t_pm.tree_map(torch.from_numpy, g),
                                      ts, tp)
        assert tp2 is tp and ts2 is ts              # updated in place
        assert float(tnorm) == pytest.approx(float(rnorm), rel=RTOL)
    _close_trees(tp, jax.tree.map(np.asarray, rp))
    rsn = jax.tree.map(np.asarray, rs)
    assert int(ts["step"]) == int(rsn.pop("step")) == n_updates
    assert ts["step"].dtype == torch.int32
    tsn = {k: v for k, v in ts.items() if k != "step"}
    _close_trees(tsn, rsn)


def tp_dtype(tree, path):
    for part in path.strip("/").split("/"):
        tree = tree[part]
    return tree.dtype


def test_bf16_parameters_update_in_their_dtype():
    """A bf16 master is updated in float32 and written back in bf16, as
    the reference's ``astype(p.dtype)``: after one step each element is
    within one bf16 spacing of the reference's (float32 sums in another
    order may round to the neighbouring bf16 value)."""
    params = _grad_tree(7)
    g = _grad_tree(8)
    for name in ("adamw", "adafactor"):
        ropt = r_opt.make_optimizer(name, lr=1e-2, warmup=1, total=10)
        topt = t_opt.make_optimizer(name, lr=1e-2, warmup=1, total=10)
        rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
        tp = t_pm.tree_map(lambda a: torch.from_numpy(a).bfloat16(), params)
        rp, _, _ = ropt.update(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
            ropt.init(rp), rp)
        topt.update(t_pm.tree_map(lambda a: torch.from_numpy(a).bfloat16(),
                                  g), topt.init(tp), tp)
        fr = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), rp))
        ft = _flat(t_pm.tree_map(lambda t: t.float(), tp))
        for k in fr:
            assert tp_dtype(tp, k) == torch.bfloat16
            # one bf16 spacing: the float32 update rounds once to bf16
            np.testing.assert_allclose(ft[k], fr[k], rtol=2 ** -8, atol=0,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges_on_quadratic(name):
    opt = t_opt.make_optimizer(name, lr=0.1, warmup=5, total=200)
    params = {"w": torch.ones((4, 8)), "b": torch.zeros((8,))}
    state = opt.init(params)

    def loss(p):
        return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()

    for _ in range(150):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(live, torch.autograd.grad(loss(live),
                                               list(live.values()))))
        opt.update(g, state, params)
    assert float(loss(params)) < 0.5


def test_adafactor_state_is_factored():
    opt = t_opt.make_optimizer("adafactor")
    state = opt.init({"w": torch.ones((64, 128))})
    assert sum(t.numel() for t in t_pm.tree_leaves(state["v"])) == 64 + 128
    assert opt.init({"w": torch.ones((3, 64, 128))})["v"]["w"]["vc"].shape \
        == (3, 128)


def test_state_specs_and_unknown_optimizer_raise():
    for name in ("adamw", "adafactor"):
        with pytest.raises(NotImplementedError, match="A14b"):
            t_opt.make_optimizer(name).state_specs({})
    with pytest.raises(ValueError):
        t_opt.make_optimizer("sgd")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_reference_crosses_a_training_state(name):
    """A reference state after two updates crosses over by
    ``convert.opt_state_from_reference``; the port's next update from it
    equals the reference's next update."""
    params = _grad_tree(3)
    ropt = r_opt.make_optimizer(name, lr=1e-2, warmup=2, total=20)
    topt = t_opt.make_optimizer(name, lr=1e-2, warmup=2, total=20)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt.init(rp)
    for i in range(2):
        rp, rs, _ = ropt.update(jax.tree.map(jnp.asarray, _grad_tree(10 + i)),
                                rs, rp)
    tp = t_pm.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), rp)
    ts = t_convert.opt_state_from_reference(jax.tree.map(np.asarray, rs), tp,
                                            topt)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    g = _grad_tree(20)
    rp, rs, _ = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
    topt.update(t_pm.tree_map(torch.from_numpy, g), ts, tp)
    _close_trees(tp, jax.tree.map(np.asarray, rp))
    bad = jax.tree.map(np.asarray, rs)
    bad.pop("step")
    with pytest.raises(ValueError, match="keys"):
        t_convert.opt_state_from_reference(bad, tp, topt)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b",
                                  "whisper-medium", "falcon-mamba-7b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (7, 3)])
def test_token_batch_is_bit_equal_to_the_reference(arch, step, seed):
    cfg_r, cfg_t = r_base.reduced_config(arch), t_base.reduced_config(arch)
    ref = r_pipe.token_batch(cfg_r, step, 3, 16, seed)
    got = t_pipe.token_batch(cfg_t, step, 3, 16, seed)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_token_batches_prefetch_onto_the_device():
    cfg = t_base.reduced_config("qwen2-0.5b")
    it = t_pipe.token_batches(cfg, 2, 8, start_step=3, device="cpu",
                              prefetch=2)
    first, second = next(it), next(it)
    it.close()
    for got, step in ((first, 3), (second, 4)):
        want = t_pipe.token_batch(cfg, step, 2, 8)
        assert got["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(tn(got["tokens"]), want["tokens"])
        np.testing.assert_array_equal(tn(got["labels"]), want["labels"])


# ---------------------------------------------------------------------------
# the fault-tolerance supervisor (the reference's
# tests/test_ckpt_ft_pipeline.py cases, through the port's Checkpointer)
# ---------------------------------------------------------------------------


def test_supervisor_restarts_after_failure(tmp_path):
    ck = Checkpointer(tmp_path)
    calls = {"fail": True, "restarts": 0}

    def step_fn(state, step):
        if step == 5 and calls["fail"]:
            calls["fail"] = False
            raise RuntimeError("injected node failure")
        return state + 1

    def restore():
        t, at = ck.restore(torch.tensor(0), device="cpu")
        return int(t), at

    sup = Supervisor(step_deadline_s=60,
                     on_restart=lambda n: calls.__setitem__("restarts", n))
    out = sup.run(n_steps=10, make_state=lambda: 0, step_fn=step_fn,
                  save=lambda s, st: ck.save(s, torch.tensor(st),
                                             blocking=True),
                  restore=restore, ckpt_every=2)
    assert calls["restarts"] == 1
    assert int(out) == 10       # every step ran exactly once post-resume


def test_supervisor_straggler_deadline():
    sup = Supervisor(step_deadline_s=0.3, max_restarts=0)

    def slow_step(state, step):
        if step == 1:
            time.sleep(1.0)      # straggling step
        return state

    with pytest.raises((StepTimeout, RuntimeError)):
        sup.run(n_steps=5, make_state=lambda: 0, step_fn=slow_step,
                save=lambda s, st: None,
                restore=lambda: (_ for _ in ()).throw(FileNotFoundError()),
                ckpt_every=0)


def test_supervisor_gives_up_after_max_restarts_like_the_reference():
    """A step that always fails: both supervisors restart ``max_restarts``
    times, then raise the step's error."""
    for mod in (r_ft, None):
        sup = (mod.Supervisor if mod else Supervisor)(
            step_deadline_s=60, max_restarts=2)
        seen = []
        sup.on_restart = seen.append

        def bad(state, step):
            raise ValueError("always")

        with pytest.raises(ValueError, match="always"):
            sup.run(n_steps=3, make_state=lambda: 0, step_fn=bad,
                    save=lambda s, st: None,
                    restore=lambda: (_ for _ in ()).throw(
                        FileNotFoundError()), ckpt_every=0)
        assert seen == [1, 2]
    assert threading.active_count() < 50


# ---------------------------------------------------------------------------
# the analytic FLOP / byte model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_analytic_flops_and_bytes_equal_the_reference(arch):
    assert t_an.n_params(t_base.get_config(arch)) == \
        r_an.n_params(r_base.get_config(arch))
    assert t_an.n_active_params(t_base.get_config(arch)) == \
        r_an.n_active_params(r_base.get_config(arch))
    for shape in r_base.SHAPES:
        for kw in ({}, {"remat": "none"}, {"remat": "dots"},
                   {"layout": "serve_tp"}, {"ep": True},
                   {"param_dtype": "bfloat16", "microbatch": 4}):
            r, t = r_an.cell_model(arch, shape, **kw), \
                t_an.cell_model(arch, shape, **kw)
            assert (t.flops, t.model_flops, t.hbm_bytes) == \
                (r.flops, r.model_flops, r.hbm_bytes), (shape, kw)
        moe = r_base.get_config(arch).moe is not None
        for kw in ({}, {"multi_pod": True}, {"layout": "dp_all"},
                   {"layout": "moe_dp"}, {"layout": "serve_tp"},
                   {"backend": "clusterkv"}) + (({"ep": True},) if moe
                                                 else ()):
            assert t_an.analytic_collectives(arch, shape, **kw) == \
                r_an.analytic_collectives(arch, shape, **kw), (shape, kw)
        seq, batch, _ = r_base.SHAPES[shape]
        for backend in ("flash", "clusterkv"):
            assert t_an.decode_cache_read_bytes(
                t_base.get_config(arch), batch, seq, backend) == \
                r_an.decode_cache_read_bytes(r_base.get_config(arch), batch,
                                             seq, backend)


def test_analytic_rates_are_the_cards():
    """Only the rates differ from the reference's: the port prices with the
    H100 knobs (bf16 on the tensor cores)."""
    from repro_torch.core.costmodel import get_hardware
    hw = get_hardware()
    assert t_an.PEAK_FLOPS == hw.bf16_flops == 989e12
    assert t_an.HBM_BW == hw.hbm_bw and t_an.LINK_BW == hw.nvlink_bw
