"""GPipe pipeline parallelism (``launch.pp.pipeline_apply``) on a process
mesh against the reference's ``pipeline_apply`` and sequential stage
application: the reference's four stages (``tests/test_pp.py``'s seed and
sizes) on four ``gloo`` ranks, the stage weights whole on every rank or
one stage per rank as DTensors, and one stage on a world of one. Every
rank's output within ``1e-5`` of both; and under autograd (ROADMAP C47)
every rank's gradients of ``w``, ``b`` and ``x`` within ``1e-5`` of the
reference's ``jax.grad`` through its ``pipeline_apply`` and of sequential
application (float64 autograd)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_mesh_harness as H

SRC = str(Path(__file__).resolve().parents[1] / "src")

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, SRC)
import numpy as np, jax, jax.numpy as jnp
from repro.launch.pp import pipeline_apply
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4), ("model",))
a = np.load(OUT + "/inputs.npz")
def stage_fn(p, xm):
    return jnp.tanh(xm @ p["w"] + p["b"])
y = pipeline_apply({"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])},
                   jnp.asarray(a["x"]), stage_fn, mesh, microbatches=4)
np.save(OUT + "/y_ref.npy", np.asarray(y))
if "cot" in a:
    def loss(w, b, x):
        y = pipeline_apply({"w": w, "b": b}, x, stage_fn, mesh,
                           microbatches=4)
        return jnp.sum(y * jnp.asarray(a["cot"]))
    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(a["w"]), jnp.asarray(a["b"]), jnp.asarray(a["x"]))
    np.savez(OUT + "/grad_ref.npz", dw=np.asarray(g[0]), db=np.asarray(g[1]),
             dx=np.asarray(g[2]))
'''


def _inputs(stages, seed=0, batch=8, d=16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((stages, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((stages, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((batch, d)).astype(np.float32)
    return w, b, x


def _sequential_grads(w, b, x, cot):
    """Gradients of ``sum(y * cot)`` through the stages applied in turn, in
    float64 autograd."""
    import torch

    wt, bt, xt = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (w, b, x))
    y = xt
    for s in range(w.shape[0]):
        y = torch.tanh(y @ wt[s] + bt[s])
    (y * torch.from_numpy(cot).double()).sum().backward()
    return {"dw": wt.grad.numpy(), "db": bt.grad.numpy(),
            "dx": xt.grad.numpy()}


def _run_reference(tmp_path):
    code = f"SRC = {SRC!r}\nOUT = {str(tmp_path)!r}\n" + REFERENCE
    return subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, JAX_PLATFORMS="cpu"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _sequential(w, b, x):
    y = x.astype(np.float64)
    for s in range(w.shape[0]):
        y = np.tanh(y @ w[s] + b[s])
    return y


@pytest.mark.parametrize("split", [False, True], ids=["whole", "dtensor"])
def test_four_stages_match_the_reference_and_sequential(tmp_path, split):
    w, b, x = _inputs(4)
    np.savez(tmp_path / "inputs.npz", w=w, b=b, x=x)
    code = f"SRC = {SRC!r}\nOUT = {str(tmp_path)!r}\n" + REFERENCE
    ref = subprocess.Popen([sys.executable, "-c", code],
                           env=dict(os.environ, JAX_PLATFORMS="cpu"),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        res = H.spawn("pipeline", 4, tmp_path / "ranks", timeout=120, w=w,
                      b=b, x=x, microbatches=4, split=split)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    y_ref = np.load(tmp_path / "y_ref.npy")
    seq = _sequential(w, b, x)
    for r in res:
        np.testing.assert_allclose(r["y"], y_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["y"], seq, rtol=0, atol=1e-5)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_one_stage_is_sequential_application(tmp_path, microbatches):
    w, b, x = _inputs(1, seed=1)
    res = H.spawn("pipeline", 1, tmp_path, timeout=60, w=w, b=b, x=x,
                  microbatches=microbatches, split=False)
    np.testing.assert_allclose(res[0]["y"], _sequential(w, b, x), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("split", [False, True], ids=["whole", "dtensor"])
def test_four_stage_gradients_match_jax_grad_and_sequential(tmp_path, split):
    """C47: the hops, the record and the final sum are differentiable.
    Every rank's gradients of ``sum(y * cot)`` with respect to the stage
    weights (whole on every rank, or one stage per rank, gathered), the
    biases and ``x`` equal the reference's ``jax.grad`` and sequential
    application within ``1e-5``."""
    w, b, x = _inputs(4)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, b=b, x=x, cot=cot)
    ref = _run_reference(tmp_path)
    try:
        res = H.spawn("pipeline", 4, tmp_path / "ranks", timeout=120, w=w,
                      b=b, x=x, microbatches=4, split=split, cot=cot)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    g_ref = dict(np.load(tmp_path / "grad_ref.npz"))
    seq = _sequential_grads(w, b, x, cot)
    assert np.abs(seq["dw"]).max(axis=(1, 2)).min() > 1e-2  # every stage
    for r, got in enumerate(res):
        for k in ("dw", "db", "dx"):
            np.testing.assert_allclose(got[k], g_ref[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(got[k], seq[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


def test_one_stage_gradients_are_sequential(tmp_path):
    """A world of one: the gradients through ``pipeline_apply`` are those
    of the one stage applied to the whole batch."""
    w, b, x = _inputs(1, seed=1)
    cot = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)
    res = H.spawn("pipeline", 1, tmp_path, timeout=60, w=w, b=b, x=x,
                  microbatches=4, split=False, cot=cot)
    seq = _sequential_grads(w, b, x, cot)
    for k in ("dw", "db", "dx"):
        np.testing.assert_allclose(res[0][k], seq[k], rtol=0, atol=1e-5,
                                   err_msg=k)
