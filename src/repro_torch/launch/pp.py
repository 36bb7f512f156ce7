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


def _stage_params(stage_params, stage_id: int):
    """This rank's stage of a tree whose leaves have a leading stage axis:
    a DTensor split over that axis gives its local ``(1, ...)`` block, a
    whole tensor its row ``stage_id``."""
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return a[stage_id]
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
    other ranks and summed over ``axis`` (the reference's ``psum``)."""
    import torch.distributed as dist

    dm = getattr(mesh, "device_mesh", None)
    if dm is None:
        raise ValueError("pipeline_apply needs a process mesh "
                         "(launch.mesh.init_process_mesh)")
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % microbatches:
        raise ValueError("batch must divide into microbatches")
    xm = x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))
    j = mesh.axis_names.index(axis)
    coord = dm.get_coordinate()
    stage_id = coord[j]
    group = dm.get_group(axis)

    def rank_at(s: int) -> int:
        at = list(coord)
        at[j] = s % n_stages
        return int(dm.mesh[tuple(at)])

    nxt, prv = rank_at(stage_id + 1), rank_at(stage_id - 1)
    p_here = _stage_params(stage_params, stage_id)
    buf = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(microbatches + n_stages - 1):
        # stage 0 injects microbatch t (the last one again once all are in)
        x_in = xm[min(t, microbatches - 1)] if stage_id == 0 else buf
        y = stage_fn(p_here, x_in)
        # the last stage records its output for microbatch t - (S - 1)
        slot = t - (n_stages - 1)
        if slot >= 0 and stage_id == n_stages - 1:
            outs[slot] = y
        if n_stages == 1:
            buf = y
            continue
        recv = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for r in reqs:
            r.wait()
        buf = recv
    if stage_id != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs.reshape((b,) + tuple(x.shape[1:]))
