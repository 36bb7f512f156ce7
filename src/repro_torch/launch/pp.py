"""Pipeline parallelism (GPipe-style) over a mesh axis, the reference's
``launch/pp.py``.

Stages live one per rank along ``axis`` of a process mesh
(``launch.mesh.init_process_mesh``); microbatches stream through with one
hop per tick, a ``batch_isend_irecv`` ring over the axis's process group
(the reference's ``lax.ppermute``). With M microbatches and S stages the
schedule runs M + S - 1 ticks (bubble fraction (S-1)/(M+S-1)); activations
hop stage to stage instead of weights moving.

This is the demonstration/ablation path, as in the reference: the
production layouts use DP/TP/EP.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.param import tree_map
from repro_torch.models.sharding import _EnterGroup, _SumOverGroup


class _Hop(torch.autograd.Function):
    """One tick's hop along the ring: forward sends ``y`` to ``nxt`` and
    returns what ``prv`` sent; backward sends the gradient of what came in
    back to ``prv`` and returns the gradient ``nxt`` sends back for ``y``
    (the transpose of ``lax.ppermute``: the same hop the other way)."""

    @staticmethod
    def forward(ctx, y, nxt, prv, group):
        ctx.ring = (nxt, prv, group)
        return _exchange(y, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prv, group = ctx.ring
        return _Hop.apply(g, prv, nxt, group), None, None, None


def _exchange(y: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    import torch.distributed as dist

    recv = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y.contiguous(), to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv


def _stage_params(stage_params, stage_id: int, group):
    """This rank's stage of a tree whose leaves have a leading stage axis:
    a DTensor split over that axis gives its local ``(1, ...)`` block, a
    whole tensor its row ``stage_id`` (entered into ``group``, so that
    backward sums every rank's gradient of the whole tensor: each rank
    holds the gradient of every stage, as ``jax.grad`` of the reference's
    replicated argument does)."""
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return _EnterGroup.apply(a, group)[stage_id]
    return tree_map(one, stage_params)


def pipeline_apply(stage_params, x: torch.Tensor, stage_fn: Callable, mesh,
                   axis: str = "model", microbatches: int = 4
                   ) -> torch.Tensor:
    """Apply ``mesh.shape[axis]`` sequential stages to ``x`` (B, ...) with
    GPipe.

    stage_params: tree whose leaves have a leading stage axis of size
    ``mesh.shape[axis]`` (whole on every rank, or DTensors split over
    ``axis``: one stage per rank). ``stage_fn(local_params, x_mb) ->
    y_mb``, the same shape as ``x_mb``. Every rank passes the same ``x``
    and gets the whole output: the last stage's outputs, masked on the
    other ranks and summed over ``axis`` (the reference's ``psum``).

    Differentiable as the reference's is under ``jax.grad``: each hop's
    backward sends the gradient back along the ring, the record and the
    masks are out-of-place selections (``torch.where``, ``index_copy``),
    the final sum's backward is the identity on every rank, and ``x`` and
    whole stage parameters enter the group, so every rank gets the whole
    gradient of each. Every rank must run the backward (each hop's
    backward is an exchange with both neighbours)."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        raise ValueError("pipeline_apply needs a process mesh "
                         "(launch.mesh.init_process_mesh)")
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % microbatches:
        raise ValueError("batch must divide into microbatches")
    j = mesh.axis_names.index(axis)
    coord = dm.get_coordinate()
    stage_id = coord[j]
    group = dm.get_group(axis)
    x = _EnterGroup.apply(x, group)
    xm = x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))

    def rank_at(s: int) -> int:
        at = list(coord)
        at[j] = s % n_stages
        return int(dm.mesh[tuple(at)])

    nxt, prv = rank_at(stage_id + 1), rank_at(stage_id - 1)
    p_here = _stage_params(stage_params, stage_id, group)
    first = torch.tensor(stage_id == 0, device=x.device)
    buf = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(microbatches + n_stages - 1):
        # stage 0 injects microbatch t (the last one again once all are in)
        x_in = torch.where(first, xm[min(t, microbatches - 1)], buf)
        y = stage_fn(p_here, x_in)
        # the last stage records its output for microbatch t - (S - 1)
        slot = t - (n_stages - 1)
        valid = torch.tensor(slot >= 0 and stage_id == n_stages - 1,
                             device=x.device)
        at = torch.tensor([min(max(slot, 0), microbatches - 1)],
                          device=x.device)
        outs = torch.where(valid, outs.index_copy(0, at, y[None]), outs)
        buf = y if n_stages == 1 else _Hop.apply(y, nxt, prv, group)
    last = torch.tensor(stage_id == n_stages - 1, device=x.device)
    outs = _SumOverGroup.apply(torch.where(last, outs, torch.zeros_like(outs)),
                               group)
    return outs.reshape((b,) + tuple(x.shape[1:]))
