"""Distributed block-sparse interaction over a device mesh.

The paper parallelizes SpMV with pthreads over row blocks; the port shards
row blocks over the devices of a :class:`~repro_torch.launch.mesh.Mesh`.
Because the dual-tree ordering makes each row-block's column footprint
compact, every shard needs only a small window of the charge vector. The
registry backend ``dist`` realizes that window as the minimal halo
exchange of :mod:`repro_torch.core.shardplan`, which runs each shard
through the SpMV kernel B2 on a card (the plain einsum on the CPU). Its
``allgather`` mode, which replicates the charges, is the traffic baseline
the halo exchange is measured against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import register_backend
from repro_torch.launch.mesh import Mesh


@register_backend("dist")
def _dist_backend(plan, x: torch.Tensor, *, mesh: Optional[Mesh] = None,
                  axis: str = "data", **_kw) -> torch.Tensor:
    """InteractionPlan SpMV with row-blocks sharded over a mesh axis.

    Routes through :mod:`repro_torch.core.shardplan`: the plan is sharded
    once (halo exchange analyzed from its ELL schedule, memoized on the
    plan host per mesh shape) and every later call reuses the shards. With
    no mesh given, shards over ``default_mesh(axis)`` on the plan's device
    type (every card, or the one CPU). Only single-vector charges (``x``
    of shape (n,)) are supported.
    """
    from repro_torch.core.shardplan import shard

    return shard(plan, mesh, axis=axis).apply(x)
