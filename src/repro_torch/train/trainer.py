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

Training on a mesh (``mesh=`` and ``train_shardings``, the reference's
logical-to-physical sharding of parameters, state and batch) is the mesh
half of training, ROADMAP A14b, and raises here.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.sharding import NO_SHARD, ShardCtx
from repro_torch.optim.optimizers import make_optimizer


def _no_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} on a mesh (sharded parameters, state and batch) is not "
        "ported to repro_torch yet (port queue item A14b in ROADMAP.md)")


def make_train_step(cfg: ModelConfig, mesh=None, backend: str = "flash",
                    microbatch: int = 1, compress_grads: bool = False,
                    optimizer=None) -> Tuple[Callable, object]:
    """Returns ``(step, optimizer)``. ``step(params, opt_state, batch)`` ->
    ``(params, opt_state, {"loss", "grad_norm"})``, both trees updated in
    place; the metrics are float32 scalar tensors on the parameters'
    device (reading them is the step's one host sync). The batch's leading
    axis is split into ``microbatch`` equal slices."""
    if mesh is not None:
        raise _no_mesh("make_train_step")
    mod = model_api.module_for(cfg)
    opt = optimizer or make_optimizer(cfg.optimizer)

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
                with torch.no_grad():
                    if compress_grads:
                        # bf16-compressed accumulation, float32 error
                        # feedback
                        g32 = torch._foreach_add(err, [a.float() for a in g])
                        gq = [a.to(torch.bfloat16) for a in g32]
                        gqf = [a.float() for a in gq]
                        err = torch._foreach_sub(g32, gqf)
                        torch._foreach_add_(gacc, gqf)
                    else:
                        torch._foreach_add_(gacc, [a.float() for a in g])
                    loss = loss + l.float()
                del g
            with torch.no_grad():
                torch._foreach_div_(gacc, microbatch)
            grads = _as_tree(params, gacc)
            loss = loss / microbatch
        else:
            loss, g = loss_and_grads(params, batch)
            grads = _as_tree(params, list(g))
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.float(), "grad_norm": gnorm}

    return step, opt


def _as_tree(params, leaves: list):
    """``leaves`` (in ``tree_leaves(params)`` order) in ``params``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def train_shardings(cfg: ModelConfig, mesh, opt, batch_parts):
    """The reference's (in, out) PartitionSpec trees for its jit: not
    ported (ROADMAP A14b)."""
    raise _no_mesh("train_shardings")


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
