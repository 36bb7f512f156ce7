"""Dry run: trace one step of every (arch x shape x mesh) cell without
allocating it, and record per rank its FLOPs, its collectives and its peak
memory, as the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell with abstract inputs over a
mesh of 256 or 512 devices and reads ``memory_analysis``,
``cost_analysis`` and the collectives of the partitioned HLO. PyTorch has
no HLO, so the port runs the step itself, in one process, over a world of
ranks that exist only as a process group's size (the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``): ``make_production_mesh``
forms over it, every parameter, optimizer state and cache leaf is a
DTensor over ``FakeTensor`` local shards at its spec (``DTensor.from_local``:
placing them issues no collective), and the step runs under
``FakeTensorMode``: shapes, dtypes and devices only, no memory. The
counters watch rank 0's local ops (every rank's shards have one shape):

- ``cost.flops``: FLOPs by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry; B5/B6 through their own formulas, as
  the opaque ops of ``kernels/library.py``);
- ``collectives``: the result bytes of each ``c10d`` and
  ``_c10d_functional`` op, in the reference's schema and ring factors
  (all-reduce 2x, the others 1x): DTensor redistributes, ``ShardCtx``'s
  per-layer gathers, ``TensorSplit``'s sums, the MoE's all-to-alls. The
  port's step runs every layer in Python, so all of it is ``entry`` and
  ``body`` is zero;
- ``memory.peak_bytes``: the rank's peak of live tensors, its arguments
  included (``torch.distributed._tools.mem_tracker.MemTracker``).

Neither counter sees the ops DTensor runs inside its sharding propagation
(fake tensors of an op's global shapes, which no rank holds).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh 16x1
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json. ``--mesh
DxM`` (or ``PxDxM``) traces a fake world of that shape over ("data",
"model") (or ("pod", "data", "model")) in place of the production one:
``16x1`` is the same 256-row cell with 16 rows a rank and no tensor
split. The
trace touches no card; ``--device`` names the device the fake tensors
claim (default ``cuda``, what the card runs: the kernels' opaque ops;
``cpu`` traces the plain versions, and is what a box without CUDA can
trace, since fake CUDA tensors there cannot run every op's meta kernel).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch.mesh import Mesh, init_process_mesh
from repro_torch.models import model_api
from repro_torch.models import param as pm
from repro_torch.models.sharding import (NamedSharding, placements,
                                         set_layout, shardings_for)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# collective ops and ring-model link traffic factors (x local bytes)
# def lines look like:  %all-reduce.140 = f32[8192,9496]{1,0} all-reduce(...)
_COLL_RE = re.compile(
    r" (all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_SHAPE_RE = re.compile(r"(f32|bf16|f16|f64|s32|u32|s8|u8|pred|s64|u64)"
                       r"\[([0-9,]*)\]")
_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4, "u32": 4,
          "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def _fresh() -> dict:
    return {"bytes_by_op": {k: 0.0 for k in _FACTOR},
            "counts": {k: 0 for k in _FACTOR}, "weighted_bytes": 0.0}


def _sections(entry: dict, body: dict) -> dict:
    total = {k: entry["bytes_by_op"][k] + body["bytes_by_op"][k]
             for k in _FACTOR}
    return {"entry": entry, "body": body, "bytes_by_op": total,
            "weighted_bytes": entry["weighted_bytes"]
            + body["weighted_bytes"]}


def parse_collectives(hlo_text: str) -> dict:
    """Sum per-device result bytes of collective ops in a partitioned HLO
    text, weighted by a ring-model traffic factor (all-reduce ~ 2x), as
    the reference's: ops in the ENTRY computation (executed once) under
    'entry', the rest (while/scan bodies, counted once in the text but run
    trip-count times) under 'body'. The port makes no HLO; this reads the
    reference's texts, so that ``roofline`` reads either package's
    records."""
    sections = {"entry": _fresh(), "body": _fresh()}
    current = "body"
    for line in hlo_text.splitlines():
        ls = line.strip()
        if ls.startswith("ENTRY "):
            current = "entry"
        elif ls.endswith("{") and not ls.startswith("ENTRY") and "=" not in ls:
            current = "body"
        m = _COLL_RE.search(line)
        if not m or " = " not in line:
            continue
        op = m.group(1)
        # result shape = last shape before the op token
        shapes = [(sm.start(), sm.group(1), sm.group(2))
                  for sm in _SHAPE_RE.finditer(line[:m.start()])]
        if not shapes:
            continue
        _, dtype, dims = shapes[-1]
        size = _BYTES[dtype]
        for d in dims.split(","):
            if d:
                size *= int(d)
        sec = sections[current]
        sec["bytes_by_op"][op] += size
        sec["counts"][op] += 1
        sec["weighted_bytes"] += size * _FACTOR[op]
    return _sections(sections["entry"], sections["body"])


# ---------------------------------------------------------------------------
# counting a traced step
# ---------------------------------------------------------------------------

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def collective_kind(name: str) -> Optional[str]:
    """The reference's collective kind of a ``c10d`` /
    ``_c10d_functional`` op name (None: not a transfer, e.g. a wait or a
    barrier)."""
    n = name.lower()
    if "wait" in n or "barrier" in n:
        return None
    if "all_to_all" in n or "alltoall" in n:
        return "all-to-all"
    if "reduce_scatter" in n:
        return "reduce-scatter"
    if "all_gather" in n or "allgather" in n:
        return "all-gather"
    if "all_reduce" in n or "allreduce" in n or n.startswith("reduce"):
        return "all-reduce"
    if n.startswith(("send", "recv", "broadcast", "scatter", "gather")):
        return "collective-permute"
    return None


class StepCounters(TorchDispatchMode):
    """Counts this rank's FLOPs and collectives of the ops run under it.

    DTensor ops pass through uncounted (``NotImplemented``: DTensor first
    turns them into local ops and collectives, which are counted), so
    every number is one rank's. FLOPs use ``FlopCounterMode``'s formula
    registry (``torch.utils.flop_counter.flop_registry``), with its
    fallback of counting a composite op's decomposition. A collective
    counts its result: the returned tensors of a functional op, the output
    argument of an in-place ``c10d`` op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = _fresh()
        self.kernel_ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _PROPAGATING[0]:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        ns = func.namespace
        if packet not in flop_registry and ns not in _COLLECTIVE_NAMESPACES \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if ns == "repro_torch":
            name = packet.__name__
            self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if ns in _COLLECTIVE_NAMESPACES:
            kind = collective_kind(packet.__name__)
            if kind is not None:
                result = out if ns != "c10d" else args[0]
                size = sum(t.numel() * t.element_size()
                           for t in tree_leaves(result)
                           if isinstance(t, torch.Tensor))
                c = self.collectives
                c["bytes_by_op"][kind] += size
                c["counts"][kind] += 1
                c["weighted_bytes"] += size * _FACTOR[kind]
        return out

    def report(self) -> dict:
        """The collectives in the reference's schema: all in ``entry``."""
        return _sections(self.collectives, _fresh())


# DTensor's sharding propagation runs each op once per new signature on
# fake tensors of the op's GLOBAL shapes (``_propagate_tensor_meta_non_cached``)
# to learn its output's metadata. It reuses the fake mode it finds active, so
# under the dry run's ``FakeTensorMode`` those global-shaped tensors reach
# the counters as if a rank held them (llama4-maverick's gradient clip
# formed a float32 copy of its stacked experts' gradient whole, 21.5 GB a
# layer, ROADMAP C51). The counters skip the ops run inside it; on a card it
# allocates nothing.
_PROPAGATING = [0]


@contextlib.contextmanager
def _propagation_marked():
    """Mark the ops DTensor runs inside its sharding propagation (for the
    counters to skip them) while the block runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    inner = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return inner(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = inner


def _step_mem_tracker():
    """A ``MemTracker`` that skips the ops of DTensor's sharding
    propagation (``_propagation_marked``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class StepMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _PROPAGATING[0]:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return StepMemTracker()


def _local_bytes(args: tuple) -> int:
    from torch.distributed.tensor import DTensor

    n = 0
    for t in [x for a in args for x in pm.tree_leaves(a)]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def trace_step(fn: Callable, args: tuple) -> dict:
    """Run ``fn(*args)`` once under the counters and the memory tracker:
    ``{"flops", "collectives", "kernel_ops", "peak_bytes",
    "argument_bytes"}`` of this rank (``args`` count as live from the
    start; ``kernel_ops`` counts the calls of the opaque B5/B6 ops)."""
    leaves = [t for a in args for t in pm.tree_leaves(a)
              if isinstance(t, torch.Tensor)]
    mt = _step_mem_tracker()
    mt.track_external(*leaves)
    counters = StepCounters()
    with _propagation_marked(), mt:
        with counters:
            fn(*args)
        peak = mt.get_tracker_snapshot("peak")
    return {"flops": counters.flops, "collectives": counters.report(),
            "kernel_ops": counters.kernel_ops,
            # shape-only tensors on the meta device hold no memory
            "peak_bytes": int(sum(d["Total"] for dev, d in peak.items()
                                  if torch.device(dev).type != "meta")),
            "argument_bytes": _local_bytes(args)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(shape, axes, device="cuda"):
    """A process mesh of ``shape`` over a ``fake`` process group of
    ``prod(shape)`` ranks in this process (this process is rank 0); the
    group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs this process without a "
                           "process group; one is initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_process_mesh(shape, axes, device)
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool):
    """(shape, axes, name) of ``launch.mesh.make_production_mesh``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model"), "pod2x16x16"
    return (16, 16), ("data", "model"), "pod16x16"


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _placed(meta_tree, shardings, make, device):
    """DTensors of ``meta_tree``'s shapes at ``shardings``, each from a
    local shard ``make(local_shape, dtype, device)`` (no collective)."""
    from torch.distributed.tensor import DTensor

    def one(t, sh: NamedSharding):
        dm = sh.mesh.device_mesh
        pl = placements(sh)
        local = list(t.shape)
        for a, p in zip(sh.mesh.axis_names, pl):
            if p.is_shard():
                # fit_spec keeps only the axes that divide a dim
                local[p.dim] //= sh.mesh.shape[a]
        return DTensor.from_local(make(tuple(local), t.dtype, device), dm,
                                  pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return pm.tree_map(one, meta_tree, shardings)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               backend: str | None = None, microbatch: int = 1,
               layout: str = "2d", expert_parallel: bool = False,
               param_dtype: str | None = None, remat: str | None = None, *,
               mesh: Mesh, device="cuda", cfg=None, sizes=None,
               make: Callable = _empty):
    """Returns ``(step, args, mesh, backend)``: one step of the cell, and
    its arguments placed on ``mesh`` (a process mesh) at the reference's
    specs, each local shard from ``make(shape, dtype, device)`` (under
    ``FakeTensorMode``: no memory). ``cfg`` replaces ``get_config(arch)``
    and ``sizes`` = (seq, batch) the cell's (tests trace reduced cells).
    The batch is every rank's whole batch, unplaced, as the mesh steps
    take it (ROADMAP C45). ``multi_pod`` names the mesh only."""
    import dataclasses

    from repro_torch.train import trainer

    set_layout(layout)
    cfg = cfg if cfg is not None else get_config(arch)
    if expert_parallel and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                expert_parallel=True))
    if param_dtype:
        cfg = cfg.with_(param_dtype=param_dtype)
    if remat == "none":
        cfg = cfg.with_(remat=False)
    elif remat in ("dots", "full"):
        cfg = cfg.with_(remat=True, remat_policy=remat)
    _, _, kind = SHAPES[shape_name]
    backend = backend or model_api.backend_for(cfg, shape_name)
    pshapes = model_api.param_shapes(cfg)
    params = _placed(pshapes, shardings_for(
        pshapes, model_api.param_specs(cfg), mesh), make, device)
    bshapes, _ = model_api.input_specs(cfg, shape_name, sizes)

    def token_ids(shape, dtype, dev):
        return make(shape, dtype, dev) % cfg.vocab
    batch = {k: (token_ids if not v.is_floating_point() else make)(
        tuple(v.shape), v.dtype, device) for k, v in bshapes.items()}
    if kind == "train":
        step, opt = trainer.make_train_step(cfg, mesh, backend,
                                            microbatch=microbatch)
        oshapes = opt.init(pshapes)
        state = _placed(oshapes, shardings_for(
            oshapes, opt.state_specs(model_api.param_specs(cfg)), mesh),
            make, device)
        return step, (params, state, batch), mesh, backend
    if kind == "prefill":
        return (trainer.make_prefill_step(cfg, mesh, backend),
                (params, batch), mesh, backend)
    long_ctx = shape_name.startswith("long")
    step = trainer.make_decode_step(cfg, mesh, backend, sharded_long=long_ctx)
    cshapes, cparts = model_api.cache_shapes(cfg, shape_name, sizes)
    cache = _placed(cshapes, shardings_for(cshapes, cparts, mesh), make,
                    device)
    return step, (params, cache, batch), mesh, backend


def mesh_name_of(shape, multi_pod: bool = False) -> str:
    """The record's mesh name: the reference's for the production shapes,
    else ``"fake" + "x".join(shape)``."""
    for mp in (False, True):
        sh, _, name = production_shape(mp)
        if tuple(shape) == sh:
            return name
    return "fake" + "x".join(str(n) for n in shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             backend: str | None = None, save: bool = True,
             microbatch: int = 1, tag: str = "", layout: str = "2d",
             expert_parallel: bool = False,
             param_dtype: str | None = None,
             remat: str | None = None, *, mesh=None, device="cuda",
             cfg=None, sizes=None, make: Callable | None = None) -> dict:
    """Trace one step of the cell and return (and with ``save`` write) its
    record. ``mesh``: None for ``make_production_mesh``'s shape, a shape
    tuple over ("data", "model") (or ("pod", "data", "model")) for a fake
    world of that size, both formed here and torn down after the cell; or
    a process mesh (``launch.mesh.Mesh``) already formed, on which the
    step runs for real with the local shards from ``make`` (then no fake
    mode). A cell that fails records its error and traceback."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.costmodel import make_report
    from repro_torch.models.sharding import get_layout

    if isinstance(mesh, Mesh):
        shape, axes = tuple(mesh.devices.shape), mesh.axis_names
        real = True
    else:
        if mesh is None:
            shape, axes, _ = production_shape(multi_pod)
        else:
            shape = tuple(mesh)
            axes = ("data", "model") if len(shape) == 2 else \
                ("pod", "data", "model")
        real = False
    mesh_name = mesh_name_of(shape, multi_pod)
    t0 = time.time()
    rec = make_report("dryrun", {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "error", "layout": layout, "ep": expert_parallel,
        "microbatch": microbatch, "param_dtype": param_dtype,
        "remat": remat, "chips": math.prod(shape), "device": str(device),
        "world": "process group" if real else "fake",
        "torch": torch.__version__})
    if sizes is not None:
        rec["sizes"] = list(sizes)
    before = get_layout()
    try:
        with contextlib.ExitStack() as stack:
            if not real:
                mesh = stack.enter_context(fake_world(shape, axes, device))
                stack.enter_context(FakeTensorMode())
            fn, args, mesh, backend = build_cell(
                arch, shape_name, multi_pod, backend, microbatch, layout,
                expert_parallel, param_dtype, remat, mesh=mesh,
                device=device, cfg=cfg, sizes=sizes,
                make=make or _empty)
            rec["backend"] = backend
            t1 = time.time()
            got = trace_step(fn, args)
            t2 = time.time()
        rec.update({
            "status": "ok",
            "build_s": round(t1 - t0, 1),
            "trace_s": round(t2 - t1, 1),
            "memory": {
                "argument_bytes": got["argument_bytes"],
                "output_bytes": None,
                "temp_bytes": got["peak_bytes"] - got["argument_bytes"],
                "peak_bytes": got["peak_bytes"],
                "generated_code_bytes": None,
                "alias_bytes": None,
            },
            "cost": {"flops": got["flops"]},
            "collectives": got["collectives"],
            "kernel_ops": got["kernel_ops"],
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
    finally:
        set_layout(before)
    rec["total_s"] = round(time.time() - t0, 1)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        stem = f"{arch}__{shape_name}__{mesh_name}{suffix}"
        (RESULTS / f"{stem}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--layout", default="2d")
    ap.add_argument("--ep", action="store_true")
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--remat", default=None, choices=["full", "dots", "none"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors claim (default cuda; "
                         "no card is touched)")
    ap.add_argument("--mesh", default=None,
                    help="DxM (or PxDxM): a fake world of this shape in "
                         "place of the production mesh")
    args = ap.parse_args(argv)
    shape = (tuple(int(n) for n in args.mesh.lower().split("x"))
             if args.mesh else None)
    if shape is not None and len(shape) not in (2, 3):
        ap.error(f"--mesh {args.mesh}: give DxM or PxDxM")

    cells = []
    if args.all:
        for arch, shape, _, _, _ in all_cells():
            cells.append((arch, shape))
    else:
        cells.append((args.arch, args.shape))
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if shape is not None:
        meshes = [False]

    recs = []
    for arch, cell in cells:
        for mp in meshes:
            mesh_name = (mesh_name_of(shape) if shape is not None
                         else production_shape(mp)[2])
            suffix = f"__{args.tag}" if args.tag else ""
            out = RESULTS / f"{arch}__{cell}__{mesh_name}{suffix}.json"
            if args.skip_done and out.exists() \
                    and json.loads(out.read_text()).get("status") == "ok":
                print(f"SKIP {arch} {cell} {mesh_name}")
                continue
            rec = run_cell(arch, cell, mp, args.backend,
                           microbatch=args.microbatch, tag=args.tag,
                           layout=args.layout, expert_parallel=args.ep,
                           param_dtype=args.param_dtype, remat=args.remat,
                           mesh=shape, device=args.device)
            flops = (rec.get("cost") or {}).get("flops")
            peak = (rec.get("memory") or {}).get("peak_bytes")
            print(f"{rec['status']:5s} {arch:28s} {cell:12s} {mesh_name:10s} "
                  f"trace={rec.get('trace_s')}s flops/rank={flops} "
                  f"peak/rank={peak} {rec.get('error', '')}", flush=True)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
