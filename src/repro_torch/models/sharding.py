"""The shard context that model code threads through.

:class:`ShardCtx` carries the mesh of the sharded paths: the long-context
decode shards its cache's sequence over it. Its ``cst`` returns ``x``
unchanged, because eager PyTorch has no sharding constraint and the
reference's constraint never changes values. The reference's logical-axis
layouts and spec resolution, and placing parameters over a mesh
(``shardings_for``), belong to the mesh half of training, ROADMAP A14b,
where parameter placement consumes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.launch.mesh import Mesh


def shardings_for(shapes_tree, logical_specs_tree, mesh: Mesh):
    """Placing a parameter tree over a mesh is not ported yet (ROADMAP
    A14b, training on a mesh)."""
    raise NotImplementedError(
        "shardings_for (placing parameters over a mesh) is not ported to "
        "repro_torch yet (port queue item A14b in ROADMAP.md)")


@dataclass(frozen=True)
class ShardCtx:
    """Threaded through model code: the mesh of the sharded paths (the
    long-context decode shards its cache over it)."""
    mesh: Optional[Mesh] = None

    def cst(self, x: torch.Tensor, *tokens) -> torch.Tensor:
        """The reference's activation sharding constraint: it never changes
        values, and eager PyTorch has none, so ``x`` comes back as is."""
        return x


NO_SHARD = ShardCtx(None)
