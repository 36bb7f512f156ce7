"""Worker processes of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_pp.py``): ``spawn`` starts ``world`` ranks, each joins a
``gloo`` process group through a ``file://`` rendezvous (no TCP port, so
test workers running side by side never clash) and runs one job function
of this module; each rank writes what it found to ``<out>/rank<r>.npz``.
A rank that does not finish within the time limit fails the test.

This module imports torch, numpy and the port only (no JAX): each rank
starts in a fresh interpreter and imports it.
"""
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _entry(job, rank, world, rendezvous, out, group, args):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if group:
            dist.init_process_group("gloo",
                                    init_method=f"file://{rendezvous}",
                                    rank=rank, world_size=world)
        result = globals()[job](rank, world, out, **args)
        if result is not None:
            np.savez(os.path.join(out, f"rank{rank}.npz"), **result)
        if group:
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn(job: str, world: int, out, timeout: float, group: bool = True,
          **args):
    """Run ``job`` on ``world`` gloo ranks; return each rank's results
    (dicts of arrays). Raises with the failing ranks' tracebacks, or when
    the time limit passes (every rank is then killed). ``group=False``
    starts the processes without a process group (a job that forms its
    own, e.g. a dry run's fake world)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("rank*"):
        f.unlink()
    ctx = mp.get_context("spawn")
    # a fresh file: a used one would hold the last group's stale entries
    rendezvous = out / f"rendezvous_{os.getpid()}_{time.monotonic_ns()}"
    procs = [ctx.Process(target=_entry, args=(job, r, world,
                                              str(rendezvous), str(out),
                                              group, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [(out / f"rank{r}.err").read_text()
            for r in range(world) if (out / f"rank{r}.err").exists()]
    if hung or errs or any(p.exitcode for p in procs):
        raise RuntimeError(f"job {job}: ranks {hung} still running after "
                           f"{timeout} s; exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    res = []
    for r in range(world):
        f = out / f"rank{r}.npz"
        res.append(dict(np.load(f)) if f.exists() else {})
    return res


# ---------------------------------------------------------------------------
# helpers shared by the jobs
# ---------------------------------------------------------------------------


def nest(flat: dict, prefix: str) -> dict:
    """``{"prefix/a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def flatten(tree, prefix: str, out: dict) -> dict:
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", out)
        return out
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        tree = (tree.float() if tree.is_floating_point() else tree).numpy()
    out[prefix] = np.asarray(tree)
    return out


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def train_cases(rank, world, out, ref_dir, cases):
    """One mesh train step per case on a (2, 2) ("data", "model") mesh:
    the reference's initial parameters (``<ref_dir>/<name>_init.npz``)
    crossed over, placed by ``train_shardings``'s specs, one step on the
    case's batch. Rank 0 returns every case's metrics and parameters."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs import reduced_config
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import set_layout
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    for name, arch, ep, mb, comp, opt_name, layout in cases:
        t0 = time.time()
        set_layout(layout)
        cfg = reduced_config(arch).with_(dtype="float32")
        if ep:
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                    expert_parallel=True))
        init = dict(np.load(os.path.join(ref_dir, f"{name}_init.npz")))
        params = convert.params_from_reference(nest(init, "p0"), cfg, "cpu")
        opt = make_optimizer(opt_name, lr=1e-3, warmup=1, total=10)
        state = convert.opt_state_from_reference(nest(init, "s0"), params,
                                                 opt)
        batch = {k: torch.from_numpy(v) for k, v in
                 pipeline.token_batch(cfg, 0, 4, 32).items()}
        params, state = trainer.place_train_state(cfg, mesh, opt, params,
                                                  state)
        step, _ = trainer.make_train_step(cfg, mesh, "flash", microbatch=mb,
                                          compress_grads=comp, optimizer=opt)
        p1, s1, m = step(params, state, batch)
        assert p1 is params and s1 is state
        flat = flatten(p1, f"{name}/p1", {})
        flatten(s1, f"{name}/s1", flat)
        if rank == 0:
            res.update(flat)
            res[f"{name}/loss"] = np.float64(m["loss"])
            res[f"{name}/grad_norm"] = np.float64(m["grad_norm"])
            res[f"{name}/seconds"] = np.float64(time.time() - t0)
    set_layout("2d")
    return res if rank == 0 else None


def reshard(rank, world, out, ckpt_dir):
    """Save a tree split over a 4-way ("data",) mesh; restore it onto a
    (2, 2) ("data", "model") mesh at other placements: an (8, 8) array
    from P("data") to P("data", "model"), a (16, 4) one to one dim split
    over both axes, a bf16 (3, 8, 8) stack saved in runs of its unsplit
    leading axis (``GATHER_BYTES`` made small) to P(None, None, "model"),
    and a scalar. Each rank's restored shard is held against DTensor's
    own split of the whole array."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.sharding import (NamedSharding, P, place,
                                             placements)

    mesh4 = init_process_mesh((4,), ("data",), "cpu")
    mesh22 = init_process_mesh((2, 2), ("data", "model"), "cpu")
    t = {"w": torch.arange(64.0).reshape(8, 8),
         "v": torch.arange(64.0).reshape(16, 4),
         "l": torch.randn(3, 8, 8, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16),
         "n": torch.tensor(3.0)}
    saved = {"w": P("data"), "v": P("data"), "l": P(None, "data"), "n": P()}
    wanted = {"w": P("data", "model"), "v": P(("data", "model"), None),
              "l": P(None, None, "model"), "n": P()}
    t4 = place(t, {k: NamedSharding(mesh4, s) for k, s in saved.items()})
    ckpt.GATHER_BYTES = 2 * 8 * 8 * 2       # two of "l"'s layers at a time
    ck = ckpt.Checkpointer(ckpt_dir)
    ck.save(0, t4, blocking=True)
    dist.barrier()
    sh = {k: NamedSharding(mesh22, s) for k, s in wanted.items()}
    restored, at = ck.restore(t, shardings=sh)
    assert at == 0
    res = {"mesh": np.array(restored["w"].device_mesh.shape)}
    for k, x in restored.items():
        assert isinstance(x, DTensor) and x.dtype == t[k].dtype, k
        assert x.placements == placements(sh[k]), k
        want = distribute_tensor(t[k], mesh22.device_mesh,
                                 placements(sh[k]),
                                 src_data_rank=None).to_local()
        assert torch.equal(x.to_local(), want), k
        assert torch.equal(x.full_tensor(), t[k]), k
        res[f"local/{k}"] = x.to_local().float().numpy()
    return res


def launch_restart(rank, world, out, ckpt_dir):
    """``launch.train --mesh 2,2`` twice on one checkpoint directory, the
    second after the last checkpoint is removed (see the test)."""
    import io
    import shutil
    from contextlib import redirect_stdout

    import torch.distributed as dist

    from repro_torch.launch import train

    argv = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "6",
            "--batch", "4", "--seq", "16", "--device", "cpu", "--mesh", "2,2",
            "--ckpt-every", "3", "--log-every", "1", "--ckpt-dir", ckpt_dir]
    buf = io.StringIO()
    with redirect_stdout(buf):
        first = train.main(argv)
    if rank == 0:
        assert sorted(p.name for p in Path(ckpt_dir).glob("step_*")) == \
            ["step_2", "step_5"], list(Path(ckpt_dir).iterdir())
        shutil.rmtree(Path(ckpt_dir) / "step_5")
    dist.barrier()
    with redirect_stdout(buf):
        second = train.main(argv)
    text = buf.getvalue()
    res = flatten(first, "first", {})
    flatten(second, "second", res)
    if rank != 0:
        assert text == "", text           # only rank 0 prints
        return None
    assert "mesh={'data': 2, 'model': 2}" in text, text
    at = int(text.split("resumed from the checkpoint of step ")[1].split()[0])
    res["resumed_at"] = np.int64(at)
    return res


def pipeline(rank, world, out, w, b, x, microbatches, split, cot=None):
    """``pipeline_apply`` of ``tanh(x @ w[s] + b[s])`` stages over a
    ``world``-rank ("model",) mesh; the stage weights whole on every rank,
    or (``split``) DTensors, one stage per rank. With a cotangent ``cot``
    also the gradients of ``sum(y * cot)`` with respect to ``w``, ``b`` and
    ``x`` on this rank (a DTensor's gradient gathered whole)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.launch.pp import pipeline_apply
    from repro_torch.models.sharding import NamedSharding, P, place

    mesh = init_process_mesh((world,), ("model",), "cpu")
    grad = cot is not None
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    if split:
        params = place(params, {k: NamedSharding(mesh, P("model"))
                                for k in params})
    params = {k: v.detach().requires_grad_(grad) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(grad)

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"] + p["b"])

    y = pipeline_apply(params, xt, stage_fn, mesh, microbatches=microbatches)
    res = {"y": y.detach().numpy()}
    if grad:
        (y * torch.from_numpy(cot)).sum().backward()
        for k, v in params.items():
            g = v.grad
            res[f"d{k}"] = (g.full_tensor() if isinstance(g, DTensor)
                            else g).numpy()
        res["dx"] = xt.grad.numpy()
    return res


def adafactor_leaves(rank, world, out, leaves):
    """One Adafactor update of each leaf (name -> (shape, spec)) on a
    (2, 2) ("data", "model") mesh, its state two updates old, against the
    same update of the whole leaf on this rank. Returns, per leaf, both
    results and the largest tensor (bytes) any op made during the mesh
    update, beside the shard's numel."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves_of

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.param import tree_map
    from repro_torch.models.sharding import P, place, shardings_for
    from repro_torch.optim.optimizers import make_optimizer

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            for t in leaves_of(res):
                if isinstance(t, torch.Tensor):
                    t = t.to_local() if isinstance(t, DTensor) else t
                    self.most = max(self.most,
                                    t.numel() * t.element_size())
            return res

    mesh = make_test_mesh(2, 2, device="cpu")
    opt = make_optimizer("adafactor", lr=1e-2, warmup=1, total=10)
    gen = torch.Generator().manual_seed(0)
    res = {}
    for name, (shape, spec) in leaves.items():
        p = {"w": torch.randn(shape, generator=gen)}
        g = [{"w": torch.randn(shape, generator=gen)} for _ in range(3)]
        state = opt.init(p)
        for gi in g[:2]:
            opt.update(gi, state, p)
        specs = {"w": P(*spec)}
        mp = place(p, shardings_for(p, specs, mesh))
        ms = place(state, shardings_for(state, opt.state_specs(specs), mesh))
        mg = place(g[2], shardings_for(g[2], specs, mesh))
        # (placing may share storage with the whole tensors: update a copy)
        p, state = tree_map(torch.clone, p), tree_map(torch.clone, state)
        _, _, want_norm = opt.update(g[2], state, p)
        with Largest() as peak:
            _, _, norm = opt.update(mg, ms, mp)
        res[f"{name}/mesh"] = mp["w"].full_tensor().numpy()
        res[f"{name}/whole"] = p["w"].numpy()
        for k, t in ms["v"]["w"].items():
            res[f"{name}/mesh_{k}"] = t.full_tensor().numpy()
            res[f"{name}/whole_{k}"] = state["v"]["w"][k].numpy()
        res[f"{name}/norm"] = np.float64([norm, want_norm])
        res[f"{name}/most_bytes"] = np.int64(peak.most)
        res[f"{name}/shard_numel"] = np.int64(mp["w"].to_local().numel())
    return res


def serve_config(arch: str, ckv):
    """The reduced config of ``arch`` in float32, with ClusterKV switched
    on at the overrides ``ckv`` (a dict) when given: the same on both
    packages' sides of ``tests/test_torch_dryrun.py``."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch).with_(dtype="float32")
    if ckv:
        cfg = cfg.with_(clusterkv=dataclasses.replace(
            cfg.clusterkv, enabled=True, **ckv))
    return cfg


def serve_cases(rank, world, out, ref_dir, cases):
    """Prefill and decode on a (2, 2) ("data", "model") mesh. Per case
    (name, arch, ClusterKV overrides, backend, long): the reference's
    parameters (``<name>_init.npz``) placed at ``param_specs``; one
    ``make_prefill_step(mesh=)`` on ``<name>_prefill.npz``; two
    ``make_decode_step(mesh=, sharded_long=long)`` steps from the cache of
    ``<name>_cache.npz`` placed at ``cache_specs(long)``, on the tokens of
    ``<name>_decode.npz``. Rank 0 returns the logits and caches whole."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model_api
    from repro_torch.models.sharding import place, shardings_for
    from repro_torch.train import trainer

    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    for name, arch, ckv, backend, long_ctx in cases:
        cfg = serve_config(arch, ckv)
        init = dict(np.load(os.path.join(ref_dir, f"{name}_init.npz")))
        params = convert.params_from_reference(nest(init, "p0"), cfg, "cpu")
        params = place(params, shardings_for(
            params, model_api.param_specs(cfg), mesh))
        mod = model_api.module_for(cfg)
        pre = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(ref_dir, f"{name}_prefill.npz")).items()}
        cache, logits = trainer.make_prefill_step(cfg, mesh, backend)(
            params, pre)
        assert isinstance(logits, DTensor)
        flat = flatten(cache, f"{name}/prefill_cache", {})
        flat[f"{name}/prefill_logits"] = logits.full_tensor().numpy()
        c0 = nest({k: torch.from_numpy(v) for k, v in np.load(os.path.join(
            ref_dir, f"{name}_cache.npz")).items()}, "c")
        cache = place(c0, shardings_for(c0, mod.cache_specs(cfg, long_ctx),
                                        mesh))
        toks = np.load(os.path.join(ref_dir, f"{name}_decode.npz"))["tokens"]
        step = trainer.make_decode_step(cfg, mesh, backend,
                                        sharded_long=long_ctx)
        for i in range(toks.shape[0]):
            logits, cache = step(params, cache,
                                 {"tokens": torch.from_numpy(toks[i])})
            flat[f"{name}/decode_logits{i}"] = logits.full_tensor().numpy()
        flatten(cache, f"{name}/decode_cache", flat)
        if rank == 0:
            res.update(flat)
    return res if rank == 0 else None


def _count_record(rec) -> dict:
    """A dry-run record's status, FLOPs, peak and collective counts and
    bytes as arrays (``counts/<op>``, ``bytes/<op>``)."""
    if rec["status"] != "ok":
        raise AssertionError(rec.get("traceback") or rec.get("error"))
    out = {"flops": np.int64(rec["cost"]["flops"]),
           "peak_bytes": np.int64(rec["memory"]["peak_bytes"])}
    coll = rec["collectives"]
    for op, n in coll["entry"]["counts"].items():
        out[f"counts/{op}"] = np.int64(n)
        out[f"bytes/{op}"] = np.float64(coll["entry"]["bytes_by_op"][op])
        assert coll["body"]["counts"][op] == 0
    out["weighted_bytes"] = np.float64(coll["weighted_bytes"])
    return out


def _cell_config(arch, reduced, over):
    from repro_torch.configs import reduced_config

    if not reduced:
        return None
    return reduced_config(arch).with_(**(over or {}))


def dryrun_cell(rank, world, out, arch, shape, mesh, reduced, sizes,
                microbatch=1, backend=None, over=None):
    """One dry-run cell traced on a fake world of shape ``mesh`` in this
    process (no process group before it): its counts. ``over`` replaces
    fields of the reduced config."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, shape, False, backend, save=False,
                          microbatch=microbatch, mesh=tuple(mesh),
                          device="cpu", cfg=_cell_config(arch, reduced, over),
                          sizes=sizes)
    return _count_record(rec)


def dryrun_real(rank, world, out, arch, shape, reduced, sizes,
                microbatch=1, mesh=(2, 2), over=None):
    """The same cell's step run for real on a ``mesh`` ("data", "model")
    gloo mesh under the dry run's counters, its arguments drawn from a
    seed: each rank's counts."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_process_mesh

    gen = torch.Generator().manual_seed(0)

    def make(shape_, dtype, device):
        if dtype.is_floating_point:
            return (torch.rand(shape_, generator=gen) * 0.02).to(dtype)
        return torch.randint(0, 1 << 20, shape_, generator=gen).to(dtype)

    pmesh = init_process_mesh(tuple(mesh), ("data", "model"), "cpu")
    rec = dryrun.run_cell(arch, shape, False, save=False,
                          microbatch=microbatch, mesh=pmesh, device="cpu",
                          cfg=_cell_config(arch, reduced, over),
                          sizes=sizes, make=make)
    assert rec["world"] == "process group"
    return _count_record(rec)


def split_config(arch: str, over: dict):
    """The reduced config of ``arch`` in float32 with the fields ``over``
    replaced: the same on both packages' sides of
    ``tests/test_torch_mesh_split.py``."""
    from repro_torch.configs import reduced_config

    return reduced_config(arch).with_(dtype="float32", **over)


def split_cases(rank, world, out, ref_dir, cases, shape):
    """Per case (name, arch, config overrides) on a ``shape`` ("data",
    "model") mesh: one AdamW train step from the reference's parameters
    and state (``<name>_init.npz``) on ``token_batch``'s 4 x 32 tokens,
    then ``make_prefill_step`` on ``<name>_prefill.npz`` and two
    ``make_decode_step`` steps from ``<name>_cache.npz`` on
    ``<name>_decode.npz``'s tokens. Rank 0 returns the metrics, the
    updated parameters, the logits and the caches whole."""
    import torch

    from repro_torch import convert
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import model_api
    from repro_torch.models.sharding import place, shardings_for
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    mesh = init_process_mesh(tuple(shape), ("data", "model"), "cpu")
    res = {}
    for name, arch, over in cases:
        cfg = split_config(arch, over)
        init = dict(np.load(os.path.join(ref_dir, f"{name}_init.npz")))
        params = convert.params_from_reference(nest(init, "p0"), cfg, "cpu")
        opt = make_optimizer("adamw", lr=1e-3, warmup=1, total=10)
        state = convert.opt_state_from_reference(nest(init, "s0"), params,
                                                 opt)
        batch = {k: torch.from_numpy(v) for k, v in
                 pipeline.token_batch(cfg, 0, 4, 32).items()}
        mp, ms = trainer.place_train_state(cfg, mesh, opt, params, state)
        step, _ = trainer.make_train_step(cfg, mesh, "flash", optimizer=opt)
        p1, _, m = step(mp, ms, batch)
        flat = flatten(p1, f"{name}/p1", {})
        flat[f"{name}/loss"] = np.float64(m["loss"])
        flat[f"{name}/grad_norm"] = np.float64(m["grad_norm"])
        # serving from the initial parameters
        params = place(convert.params_from_reference(nest(init, "p0"), cfg,
                                                     "cpu"),
                       shardings_for(params, model_api.param_specs(cfg),
                                     mesh))
        pre = {k: torch.from_numpy(v) for k, v in
               np.load(os.path.join(ref_dir, f"{name}_prefill.npz")).items()}
        cache, logits = trainer.make_prefill_step(cfg, mesh, "flash")(
            params, pre)
        flatten(cache, f"{name}/prefill_cache", flat)
        flat[f"{name}/prefill_logits"] = logits.full_tensor().numpy()
        c0 = nest({k: torch.from_numpy(v) for k, v in np.load(os.path.join(
            ref_dir, f"{name}_cache.npz")).items()}, "c")
        mod = model_api.module_for(cfg)
        cache = place(c0, shardings_for(c0, mod.cache_specs(cfg), mesh))
        toks = np.load(os.path.join(ref_dir, f"{name}_decode.npz"))["tokens"]
        dstep = trainer.make_decode_step(cfg, mesh, "flash")
        for i in range(toks.shape[0]):
            logits, cache = dstep(params, cache,
                                  {"tokens": torch.from_numpy(toks[i])})
            flat[f"{name}/decode_logits{i}"] = logits.full_tensor().numpy()
        flatten(cache, f"{name}/decode_cache", flat)
        if rank == 0:
            res.update(flat)
    return res if rank == 0 else None


def split_specs(rank, world, out, shape, reduced):
    """Which leaves ``model_api.compute_specs`` splits over the tensor
    axis, for every architecture's config (reduced or full), on a fake
    world of ``shape`` over ("data", "model") formed here: ``<arch>/<leaf
    path>`` -> 1 where its compute spec names "model" (or is a
    ``sharding.Part`` of it), else 0."""
    from repro_torch.configs import ARCH_IDS, get_config, reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model_api
    from repro_torch.models.sharding import Part

    res = {}
    with dryrun.fake_world(tuple(shape), ("data", "model"), "cpu") as mesh:
        for arch in ARCH_IDS:
            cfg = reduced_config(arch) if reduced else get_config(arch)

            def walk(t, path):
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, f"{path}/{k}")
                    return
                split = isinstance(t, Part) and t.axis == "model" or any(
                    e == "model" or (isinstance(e, tuple) and "model" in e)
                    for e in t)
                res[path] = np.int64(split)
            walk(model_api.compute_specs(cfg, mesh, 4096), arch)
    return res


def dryrun_propagation(rank, world, out):
    """``dryrun.trace_step`` of one DTensor op on a fake (1, 4) world under
    ``FakeTensorMode``, as the dry run traces a step: a float32 (4, 512,
    512) tensor split over "model" scaled by a plain scalar and cast to
    bf16. Its peak, the shard's and the whole tensor's bytes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import dryrun

    shape, local = (4, 512, 512), (4, 128, 512)
    with dryrun.fake_world((1, 4), ("data", "model"), "cpu") as mesh:
        with FakeTensorMode():
            t = DTensor.from_local(
                torch.empty(local), mesh.device_mesh, (Shard(1), Shard(1)),
                run_check=False, shape=shape,
                stride=(shape[1] * shape[2], shape[2], 1))
            s = torch.ones(())
            got = dryrun.trace_step(
                lambda x, y: (x.float() * y).to(torch.bfloat16), (t, s))
    return {"peak_bytes": np.int64(got["peak_bytes"]),
            "local_bytes": np.int64(4 * np.prod(local)),
            "whole_bytes": np.int64(4 * np.prod(shape))}
