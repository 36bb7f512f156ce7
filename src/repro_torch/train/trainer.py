"""Train/serve step factories, as the reference's ``train/trainer.py``.

``make_train_step`` builds the training step (forward, backward, clip,
optimizer update, metrics) for any family's config:

  - remat per layer inside the model's ``forward`` (``cfg.remat``);
  - microbatch gradient accumulation in float32; with ``compress_grads``
    each microbatch's gradient is cast to bf16 before it is added, with a
    float32 error-feedback buffer carrying what the cast dropped;
  - chunked cross-entropy inside the family's ``loss_fn``.

The step updates the parameter and state tensors it is given in place and
returns them: the counterpart of the reference's ``donate_argnums``.
Gradients are taken with respect to detached aliases of the parameters, so
the caller's tensors never require grad and serve (and launch the
kernels) as they are after training.

``make_prefill_step`` / ``make_decode_step`` build the serving steps.

On a mesh (``mesh=``, a process mesh from ``launch.mesh.
init_process_mesh``) parameters and optimizer state are DTensors placed by
``train_shardings`` (``place_train_state``): the reference's logical specs
resolved under the current layout. Every rank is handed the same whole
batch. Each rank then

  - gathers each parameter over the batch axes (ZeRO-3: a differentiable
    ``redistribute`` whose backward sums the gradient over them and
    scatters it back to the parameter's placement), keeping split over
    the tensor axis what the family computes split
    (``model_api.compute_specs``: attention heads, MLP columns and their
    output rows, Megatron-style, and the MoE experts as the FFN takes
    them). The stacked layer trees (``param.STACKS``) are gathered one
    layer at a time, inside the layer's remat (``ShardCtx.layer``), so a
    rank holds its shards of every layer and one layer gathered (two while
    backward recomputes one; every layer's, with ``cfg.remat`` off, as
    autograd keeps them); the rest (embedding, head, final norm, the
    hybrid's shared block) is gathered for the whole step;
  - takes its rows of each microbatch: microbatch ``i`` is the global
    rows ``[i*b, (i+1)*b)``, split over the batch axes as the reference's
    data-sharded slice is (MoE routing depends on which rows share a
    shard);
  - runs the family's loss on its rows (``models.moe`` splits the experts
    over the mesh) and backpropagates its share of the mean loss: each
    layer's gradient comes back summed over the batch axes and at the
    shard's size as soon as the layer's backward ends;
  - updates its shards of the parameters and state in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api
from repro_torch.models import param as pm
from repro_torch.models.param import as_tree, tree_leaves, tree_map
from repro_torch.models.sharding import (NO_SHARD, NamedSharding, P,
                                         ShardCtx, dp_axes, placements,
                                         shardings_for, spec_tree)
from repro_torch.optim.optimizers import make_optimizer


def _process_mesh(mesh):
    if getattr(mesh, "device_mesh", None) is None:
        raise ValueError(
            "training on a mesh (ROADMAP A14b) needs a process mesh "
            "(launch.mesh.init_process_mesh): parameters, state and batch "
            "are DTensors over its process group, and a single-controller "
            "Mesh has none")
    return mesh


def make_train_step(cfg: ModelConfig, mesh=None, backend: str = "flash",
                    microbatch: int = 1, compress_grads: bool = False,
                    optimizer=None) -> Tuple[Callable, object]:
    """Returns ``(step, optimizer)``. ``step(params, opt_state, batch)`` ->
    ``(params, opt_state, {"loss", "grad_norm"})``, both trees updated in
    place; the metrics are float32 scalar tensors on the parameters'
    device (reading them is the step's one host sync). The batch's leading
    axis is split into ``microbatch`` equal slices. With a process
    ``mesh`` every tree holds DTensors (``train_shardings``)."""
    opt = optimizer or make_optimizer(cfg.optimizer)
    if mesh is not None:
        return _mesh_step(cfg, _process_mesh(mesh), backend, microbatch,
                          compress_grads, opt), opt
    mod = model_api.module_for(cfg)

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = mod.loss_fn(live, cfg, batch, backend, NO_SHARD)
            # a leaf the loss does not reach gets zeros, as jax.grad's
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), grads

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatch > 1:
            leaves = tree_leaves(params)
            gacc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            err = [torch.zeros_like(g) for g in gacc] if compress_grads \
                else None
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatch):
                mb = {k: v[i * (v.shape[0] // microbatch):
                           (i + 1) * (v.shape[0] // microbatch)]
                      for k, v in batch.items()}
                l, g = loss_and_grads(params, mb)
                err = _accumulate(gacc, err, g, compress_grads)
                loss = loss + l.float()
                del g
            with torch.no_grad():
                torch._foreach_div_(gacc, microbatch)
            grads = as_tree(params, gacc)
            loss = loss / microbatch
        else:
            loss, g = loss_and_grads(params, batch)
            grads = as_tree(params, list(g))
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.float(), "grad_norm": gnorm}

    return step, opt


def _accumulate(gacc, err, g, compress: bool):
    """Add one microbatch's gradients ``g`` into ``gacc`` in float32; with
    ``compress`` each is cast to bf16 first and ``err`` (float32 error
    feedback) carries what the cast dropped. Returns the new ``err``."""
    with torch.no_grad():
        if compress:
            g32 = torch._foreach_add(err, [a.float() for a in g])
            gqf = [a.to(torch.bfloat16).float() for a in g32]
            err = torch._foreach_sub(g32, gqf)
            torch._foreach_add_(gacc, gqf)
        else:
            torch._foreach_add_(gacc, [a.float() for a in g])
    return err


def _mesh_step(cfg: ModelConfig, mesh, backend: str, microbatch: int,
               compress_grads: bool, opt) -> Callable:
    """The train step on a process mesh (see the module's docstring)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mod = model_api.module_for(cfg)
    dm = mesh.device_mesh
    names = mesh.axis_names
    dpx = dp_axes(mesh)

    def batch_axes():
        coord = dm.get_coordinate()
        rank, n = 0, 1
        for a in names:                 # the mesh's order: first is outer
            if a in dpx:
                j = names.index(a)
                rank, n = rank * mesh.shape[a] + coord[j], n * mesh.shape[a]
        return rank, n

    def gather(local, held, spec):
        """``local``, this rank's shard of a tensor split as ``held``
        (placements), as the local tensor the step computes with: gathered
        over the batch axes, split over the tensor axis as ``spec`` says. Its
        backward sums the gradient over the batch axes and gives this
        rank's shard of it."""
        target = placements(NamedSharding(mesh, spec))
        grad = [Partial() if (a in dpx and isinstance(t, Replicate)) else t
                for a, t in zip(names, target)]
        return DTensor.from_local(local, dm, held, run_check=False) \
            .redistribute(dm, target).to_local(grad_placements=grad)

    def one_layer(p, spec):
        """(placements of one layer of the stacked leaf ``p``, its spec)."""
        if any(isinstance(t, Shard) and t.dim == 0 for t in p.placements):
            raise ValueError("the layer axis of a stacked parameter is not "
                             "split on a mesh (models.param.stacked)")
        return (tuple(Shard(t.dim - 1) if isinstance(t, Shard) else t
                      for t in p.placements), P(*spec[1:]))

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        rank, n_dp = batch_axes()
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatch or (rows // microbatch) % n_dp:
            raise ValueError(
                f"a batch of {rows} rows in {microbatch} microbatch(es) does "
                f"not split evenly over the {n_dp} shards of the batch axes "
                f"{dpx}")
        b = rows // microbatch
        mine = b // n_dp
        seq = next(iter(batch.values())).shape[1]
        cspecs = model_api.compute_specs(cfg, mesh, seq)
        leaves = tree_leaves(params)
        for p in leaves:
            if not isinstance(p, DTensor):
                raise TypeError("on a mesh every parameter must be a "
                                "DTensor (models.sharding.place)")
        stacks = [k for k in params if k in pm.STACKS]
        layer_specs = {k: pm.tree_map(one_layer, params[k], cspecs[k])
                       for k in stacks}
        shd = ShardCtx(mesh, gather=lambda lp, k: pm.tree_map(
            lambda x, spec: gather(x, *spec), lp, layer_specs[k]))
        gacc = err = None
        if microbatch > 1:
            gacc = [torch.zeros_like(p.to_local(), dtype=torch.float32)
                    for p in leaves]
            err = [torch.zeros_like(a) for a in gacc] if compress_grads \
                else None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].to_local().device)
        for i in range(microbatch):
            lo = i * b + rank * mine
            mb = {k: v[lo:lo + mine] for k, v in batch.items()}
            live = [p.to_local().detach().requires_grad_(
                p.is_floating_point()) for p in leaves]
            with torch.enable_grad():
                # the stacked layer trees stay split until each layer's
                # body gathers its layer (ShardCtx.layer); the rest is
                # gathered here
                tree = as_tree(params, live)
                local = {k: v if k in stacks else pm.tree_map(
                    lambda x, p, spec: gather(x, p.placements, spec),
                    v, params[k], cspecs[k]) for k, v in tree.items()}
                loss = mod.loss_fn(local, cfg, mb, backend, shd)
                # this rank's share of the mean over the batch's shards
                g = torch.autograd.grad(loss / n_dp, live, allow_unused=True,
                                        materialize_grads=True)
            loss_sum = loss_sum + loss.detach().float()
            del local, tree
            if microbatch == 1:
                gacc = list(g)
            else:
                err = _accumulate(gacc, err, g, compress_grads)
            del g
        if microbatch > 1:
            with torch.no_grad():
                torch._foreach_div_(gacc, microbatch)
        grads = as_tree(params, [
            DTensor.from_local(a, dm, p.placements, run_check=False,
                               shape=p.shape, stride=p.stride())
            for a, p in zip(gacc, leaves)])
        for a in dpx:
            dist.all_reduce(loss_sum, group=dm.get_group(a))
        loss = loss_sum / (n_dp * microbatch)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def train_shardings(cfg: ModelConfig, mesh, opt, batch_parts):
    """The reference's ``(in, out)`` PartitionSpec trees of the step: the
    parameters', the optimizer state's and the batch's specs (``batch_parts``,
    logical, e.g. ``model_api.input_specs``'s) resolved on ``mesh``, and
    the metrics'. ``models.sharding.shardings_for`` fits them to concrete
    shapes for ``place``."""
    pspecs = model_api.param_specs(cfg)
    pspecs_r = spec_tree(pspecs, mesh)
    ospecs_r = spec_tree(opt.state_specs(pspecs), mesh)
    bspecs_r = spec_tree(batch_parts, mesh)
    metrics = {"loss": P(), "grad_norm": P()}
    return ((pspecs_r, ospecs_r, bspecs_r),
            (pspecs_r, ospecs_r, spec_tree(metrics, mesh)))


def place_train_state(cfg: ModelConfig, mesh, opt, params, opt_state):
    """``params`` and ``opt_state`` placed on ``mesh`` at their fitted specs
    (``shardings_for`` + ``place``): what ``make_train_step(mesh=)``
    takes."""
    from repro_torch.models.sharding import place

    pspecs = model_api.param_specs(cfg)
    return (place(params, shardings_for(params, pspecs, mesh)),
            place(opt_state, shardings_for(opt_state,
                                           opt.state_specs(pspecs), mesh)))


def make_prefill_step(cfg: ModelConfig, mesh=None, backend: str = "flash"):
    """``step(params, batch)`` -> ``(cache, last logits)``: the family's
    ``prefill``. ``mesh`` goes to the family in its shard context."""
    mod = model_api.module_for(cfg)
    shd = ShardCtx(mesh)

    def step(params, batch):
        return mod.prefill(params, cfg, batch, backend, shd)

    return step


def make_decode_step(cfg: ModelConfig, mesh=None, backend: str = "flash",
                     sharded_long: bool = False):
    """``step(params, cache, batch)`` -> ``(logits, cache)``: the family's
    ``decode_step`` of ``batch["tokens"]`` (or of ``batch`` itself), the
    cache written in place. With ``sharded_long`` and a ``mesh`` the
    long-context decode splits the cache over it."""
    mod = model_api.module_for(cfg)
    shd = ShardCtx(mesh)

    def step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return mod.decode_step(params, cfg, cache, tokens, backend,
                               sharded_long, shd)

    return step
