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
    (``model_api.compute_specs``: attention heads head-aligned, MLP
    columns and their output rows, Megatron-style, the MoE experts as the
    FFN takes them, the mamba layers' inner dim, the embedding's and LM
    head's vocab). A ``sharding.Part`` spec (a block that is not DTensor's
    even chunk: an uneven or head-aligned split) is gathered whole over
    the tensor axis and cut to the rank's block, its gradient summed over
    that axis. The stacked layer trees (``param.STACKS``) are gathered one
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
from repro_torch.models.sharding import (NO_SHARD, NamedSharding, P, Part,
                                         SeqSplit, ShardCtx, dp_axes,
                                         fit_spec, inner_spec, placements,
                                         resolve_spec, shardings_for,
                                         spec_tree, vocab_split)
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


def _gather(mesh):
    """``gather(local, held, spec)``: ``local``, this rank's shard of a
    tensor split as ``held`` (placements), as the local tensor a step
    computes with: gathered over the batch axes, split over the tensor
    axis as ``spec`` says (a ``Part``: whole over it, then this rank's
    blocks). Its backward sums the gradient over the batch axes (and a
    ``Part``'s over its axis) and gives this rank's shard of it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dm = mesh.device_mesh
    names = mesh.axis_names
    dpx = dp_axes(mesh)

    def gather(local, held, spec):
        target = placements(NamedSharding(mesh, spec))
        summed = dpx + ((spec.axis,) if isinstance(spec, Part) else ())
        grad = [Partial() if (a in summed and isinstance(t, Replicate))
                else t for a, t in zip(names, target)]
        out = DTensor.from_local(local, dm, held, run_check=False) \
            .redistribute(dm, target).to_local(grad_placements=grad)
        return spec.take(out) if isinstance(spec, Part) else out
    return gather


def _one_layer(p, spec):
    """(placements of one layer of the stacked leaf ``p``, its spec)."""
    from torch.distributed.tensor import Shard

    if any(isinstance(t, Shard) and t.dim == 0 for t in p.placements):
        raise ValueError("the layer axis of a stacked parameter is not "
                         "split on a mesh (models.param.stacked)")
    return (tuple(Shard(t.dim - 1) if isinstance(t, Shard) else t
                  for t in p.placements), inner_spec(spec))


def _local_tree(cfg: ModelConfig, mesh, params, seq: int, live=None):
    """``(tree, layer_gather)``: the parameters as the families compute
    with them on a process mesh at sequence length ``seq``, and the
    ``ShardCtx.gather`` that gathers one layer of a stacked tree. ``live``
    (this rank's local shards in
    ``tree_leaves`` order; default their ``to_local()``) stand in for the
    DTensors. The stacked layer trees (``param.STACKS``) stay split until
    each layer's body gathers its layer (``ShardCtx.layer``); the rest is
    gathered here, as ``model_api.compute_specs`` says."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(params)
    for p in leaves:
        if not isinstance(p, DTensor):
            raise TypeError("on a mesh every parameter must be a "
                            "DTensor (models.sharding.place)")
    if live is None:
        live = [p.to_local() for p in leaves]
    gather = _gather(mesh)
    cspecs = model_api.compute_specs(cfg, mesh, seq)
    stacks = [k for k in params if k in pm.STACKS]
    layer_specs = {k: pm.tree_map(_one_layer, params[k], cspecs[k])
                   for k in stacks}
    tree = as_tree(params, live)
    local = {k: v if k in stacks else pm.tree_map(
        lambda x, p, spec: gather(x, p.placements, spec),
        v, params[k], cspecs[k]) for k, v in tree.items()}
    return local, lambda lp, k: pm.tree_map(
        lambda x, spec: gather(x, *spec), lp, layer_specs[k])


def _mesh_step(cfg: ModelConfig, mesh, backend: str, microbatch: int,
               compress_grads: bool, opt) -> Callable:
    """The train step on a process mesh (see the module's docstring)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    mod = model_api.module_for(cfg)
    dm = mesh.device_mesh
    dpx = dp_axes(mesh)

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        rank, n_dp = _batch_block(mesh, dpx)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatch or (rows // microbatch) % n_dp:
            raise ValueError(
                f"a batch of {rows} rows in {microbatch} microbatch(es) does "
                f"not split evenly over the {n_dp} shards of the batch axes "
                f"{dpx}")
        b = rows // microbatch
        mine = b // n_dp
        seq = next(iter(batch.values())).shape[1]
        leaves = tree_leaves(params)
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
                local, layer_gather = _local_tree(cfg, mesh, params, seq,
                                                  live)
                loss = mod.loss_fn(local, cfg, mb, backend,
                                   ShardCtx(mesh, gather=layer_gather))
                # this rank's share of the mean over the batch's shards
                g = torch.autograd.grad(loss / n_dp, live, allow_unused=True,
                                        materialize_grads=True)
            loss_sum = loss_sum + loss.detach().float()
            del local, layer_gather
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


def _batch_block(mesh, axes) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a tensor dim split
    over the mesh ``axes``, in the mesh's axis order (the first is
    outer, as DTensor lays out a dim split over several axes)."""
    coord = mesh.device_mesh.get_coordinate()
    rank, n = 0, 1
    for j, a in enumerate(mesh.axis_names):
        if a in axes:
            rank, n = rank * mesh.shape[a] + coord[j], n * mesh.shape[a]
    return rank, n


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
    ``prefill``. ``mesh`` goes to the family in its shard context; on a
    process mesh (parameters DTensors at ``param_specs``) see
    :func:`_mesh_serving`."""
    mod = model_api.module_for(cfg)
    if getattr(mesh, "device_mesh", None) is not None:
        return _mesh_serving(cfg, mesh, backend, "prefill")
    shd = ShardCtx(mesh)

    def step(params, batch):
        return mod.prefill(params, cfg, batch, backend, shd)

    return step


def make_decode_step(cfg: ModelConfig, mesh=None, backend: str = "flash",
                     sharded_long: bool = False):
    """``step(params, cache, batch)`` -> ``(logits, cache)``: the family's
    ``decode_step`` of ``batch["tokens"]`` (or of ``batch`` itself), the
    cache written in place. With ``sharded_long`` and a single-controller
    ``mesh`` the long-context decode splits the cache over it; on a
    process mesh see :func:`_mesh_serving`."""
    mod = model_api.module_for(cfg)
    if getattr(mesh, "device_mesh", None) is not None:
        return _mesh_serving(cfg, mesh, backend, "decode", sharded_long)
    shd = ShardCtx(mesh)

    def step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return mod.decode_step(params, cfg, cache, tokens, backend,
                               sharded_long, shd)

    return step


def _fitted(mesh, shape, spec) -> tuple:
    """DTensor placements of logical ``spec`` fitted to ``shape``."""
    return placements(NamedSharding(mesh, fit_spec(
        tuple(shape), resolve_spec(spec, mesh), mesh)))


def _cache_placements(cfg: ModelConfig, mesh, shapes, long_context: bool):
    """The placements of each cache leaf: ``cache_specs`` fitted to the
    global ``shapes``. The families compute each leaf so on a process
    mesh: a dim split over ``tp`` where the fitted spec keeps it (the
    split is then even: heads, channels), whole where it drops it (every
    kv head gathered over ``tp``)."""
    specs = model_api.module_for(cfg).cache_specs(cfg, long_context)
    return pm.tree_map(lambda sh, sp: _fitted(mesh, sh.shape, sp), shapes,
                       specs)


def _seq_split(mesh, cache, target):
    """The ``SeqSplit`` of a decode cache whose k/v (or MLA latent)
    sequence axis is split over one mesh axis, else None."""
    from torch.distributed.tensor import Shard

    key, dim = ("c", 2) if "c" in cache else ("k", 3)
    if key not in cache:
        return None
    axes = [mesh.axis_names[i] for i, t in enumerate(target[key])
            if isinstance(t, Shard) and t.dim == dim]
    if not axes:
        return None
    if len(axes) > 1:
        raise ValueError(f"the cache sequence is split over {axes}; the "
                         "decode combines over one axis")
    a = axes[0]
    dm = mesh.device_mesh
    size = cache[key].shape[dim] // mesh.shape[a]
    return SeqSplit(a, mesh.shape[a], dm.get_group(a), dm.get_local_rank(a),
                    size)


def _mesh_serving(cfg: ModelConfig, mesh, backend: str, kind: str,
                  sharded_long: bool = False):
    """The prefill (``kind="prefill"``) or decode step on a process mesh.

    Parameters are DTensors at ``param_specs``, gathered as the mesh train
    step gathers them (``model_api.compute_specs``, the stacked layers one
    at a time through ``ShardCtx.layer``). Every rank is handed the same
    whole batch and takes its rows: the reference's batch spec
    ``P("dp", ...)`` fitted to the batch (a batch the batch axes do not
    divide is computed whole on every rank). The cache is a tree of
    DTensors at ``cache_specs`` fitted to its shapes (long-context specs
    when the decode is ``sharded_long``): the prefill returns each rank's
    part of it, the decode takes and returns each rank's part, and no
    leaf is gathered (``_cache_placements``). When the k/v sequence is
    split (a long context), each rank holds its slice and the attention
    combines the slices' partial softmaxes over that axis
    (``ShardCtx.seq``). Each rank computes its vocab columns of the
    logits (``sharding.VocabSplit``); they come back as a DTensor at
    ``P("dp", "tp")`` (gathered whole first where ``tp`` does not divide
    the vocab)."""
    from torch.distributed.tensor import DTensor

    mod = model_api.module_for(cfg)
    dm = mesh.device_mesh
    vocab = vocab_split(mesh, cfg.vocab)
    split_cols = vocab is not None and cfg.vocab % vocab.split.n == 0

    def rows_of(batch_value):
        rows = batch_value.shape[0]
        pl = _fitted(mesh, (rows,), P("dp"))
        axes = [mesh.axis_names[i] for i, t in enumerate(pl)
                if not t.is_replicate()]
        blk, n = _batch_block(mesh, axes)
        return rows, slice(blk * (rows // n), (blk + 1) * (rows // n))

    def out_logits(logits, rows):
        if vocab is not None and not split_cols:
            logits = vocab.gather(logits)
        whole = (rows, cfg.vocab)
        pl = _fitted(mesh, whole, P("dp", "tp" if split_cols else None))
        return DTensor.from_local(logits, dm, pl, run_check=False,
                                  shape=whole, stride=(whole[1], 1)
                                  ).redistribute(
            dm, _fitted(mesh, whole, P("dp", "tp")))

    def out_cache(cache, target):
        def one(x, tgt):
            shape = list(x.shape)
            for a, t in zip(mesh.axis_names, tgt):
                if t.is_shard():
                    shape[t.dim] *= mesh.shape[a]
            stride = [1] * len(shape)
            for i in range(len(shape) - 2, -1, -1):
                stride[i] = stride[i + 1] * shape[i + 1]
            return DTensor.from_local(
                x, dm, tgt, run_check=False, shape=torch.Size(shape),
                stride=tuple(stride))
        return pm.tree_map(one, cache, target)

    if kind == "prefill":
        def step(params, batch):
            first = next(iter(batch.values()))
            rows, mine = rows_of(first)
            seq = first.shape[1]
            local, gather = _local_tree(cfg, mesh, params, seq)
            mb = {k: v[mine] for k, v in batch.items()}
            with torch.no_grad():
                cache, logits = mod.prefill(local, cfg, mb, backend,
                                            ShardCtx(mesh, gather=gather))
            # the placements are fitted to init_cache's shapes (the same
            # batch and heads; the encoder's cross caches may be longer)
            shapes = mod.init_cache(cfg, rows, seq, device="meta")
            target = _cache_placements(cfg, mesh, shapes, False)
            return out_cache(cache, target), out_logits(logits, rows)
        return step

    def step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        rows, mine = rows_of(tokens)
        local, gather = _local_tree(cfg, mesh, params, tokens.shape[1])
        target = _cache_placements(cfg, mesh, cache, sharded_long)
        for x, tgt in zip(tree_leaves(cache), tree_leaves(target)):
            if tuple(x.placements) != tuple(tgt):
                raise ValueError(
                    f"a cache leaf is placed {x.placements}, the decode step "
                    f"takes it at {tgt} (cache_specs(long_context="
                    f"{sharded_long}))")
        seq = _seq_split(mesh, cache, target)
        lc = pm.tree_map(lambda x: x.to_local(), cache)
        with torch.no_grad():
            logits, lc = mod.decode_step(local, cfg, lc, tokens[mine],
                                         backend, sharded_long,
                                         ShardCtx(mesh, gather=gather,
                                                  seq=seq))
        return out_logits(logits, rows), out_cache(lc, target)
    return step
