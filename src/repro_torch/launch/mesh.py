"""Device meshes: a named grid of devices, held by one controller process
or spread over a process group.

The reference's ``jax.sharding.Mesh`` lives in one process: ``shard(plan,
mesh)`` returns one object whose ``matvec`` takes and returns the whole
charge vector, and the collectives run inside that process. The port keeps
that shape. A :class:`Mesh` is a numpy object array of ``torch.device``\\ s
plus axis names, and the sharded paths move data between its devices with
plain copies (``tensor.to(device)``) in the calling process; no process
group is involved.

A device may appear more than once (ROADMAP C32): ``[cpu] * 4`` runs a
4-way sharded path on the CPU, and ``[cuda:0] * 4`` runs it on one card,
where the reference's tests force several host devices with
``--xla_force_host_platform_device_count``. Every shard then computes on
the same device and the exchange copies are no-ops.

Training on a mesh is the other kind: one process per device, as
``torchrun`` starts them. :func:`init_process_mesh` builds a
``torch.distributed`` ``DeviceMesh`` over an initialized process group
and keeps it as the :class:`Mesh`'s ``device_mesh``; parameters, state
and batch are then DTensors over it (``models.sharding.place``). A
single-controller mesh has ``device_mesh=None``.
:func:`make_production_mesh` and :func:`make_test_mesh` give the
reference's shapes as process meshes.

Importing this module touches no device; meshes are built by functions.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["Mesh", "make_mesh", "default_mesh", "init_process_mesh",
           "make_production_mesh", "make_test_mesh"]


def _indexed(device: DeviceLike) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the current card,
    so that meshes naming it either way compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices`` (any shape) of ``torch.device``\\ s with one name per
    axis. ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does; two meshes are equal when their axes
    and devices are, and both are process meshes or neither is.
    ``device_mesh`` is the ``DeviceMesh`` of a process mesh, else
    ``None``."""

    def __init__(self, devices, axis_names: Sequence[str], device_mesh=None):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [_indexed(d) for d in np.asarray(devices, object).flat]
        arr.reshape(-1)[:] = flat
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device grid needs {arr.ndim} "
                             f"axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.device_mesh = device_mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def devices_along(self, axis: str) -> List[torch.device]:
        """The devices of ``axis``, one per position on it, the other axes
        held at their first position: where the shards of a split over
        ``axis`` live (the other axes would hold replicas)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def _key(self) -> Tuple:
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat),
                self.device_mesh is not None)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        kind = ", process mesh" if self.device_mesh is not None else ""
        return f"Mesh({self.shape}, devices={devs}{kind})"


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices= (e.g. [torch.device('cpu')] * n) "
            "to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default: every CUDA device). Too few devices raise, as
    ``jax.make_mesh`` does."""
    devs = _cuda_devices() if devices is None else [_indexed(d)
                                                    for d in devices]
    need = math.prod(shape)
    if need > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, "
                         f"{len(devs)} given")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(tuple(shape)), axes)


@functools.lru_cache(maxsize=None)
def _default_mesh(axis: str, device_type: str) -> Mesh:
    if device_type == "cuda":
        return make_mesh((torch.cuda.device_count(),), (axis,),
                         _cuda_devices())
    return make_mesh((1,), (axis,), [torch.device(device_type)])


def default_mesh(axis: str = "data", device: DeviceLike = None) -> Mesh:
    """1-axis mesh over every CUDA device (``device=None`` or a CUDA
    device), or over the one CPU device (``device="cpu"``). With no card
    and no ``device`` it raises: there is no CPU fallback. Shared by
    ``shard`` and the ``dist`` backend, so their memoized shards agree."""
    return _default_mesh(axis, resolve_device(device).type)


def init_process_mesh(shape: Sequence[int], axes: Sequence[str],
                      device: DeviceLike = None) -> Mesh:
    """A process mesh of ``shape`` over the initialized process group,
    which must hold exactly ``prod(shape)`` ranks. ``device=None`` (or a
    CUDA device) puts each rank on its local card (``LOCAL_RANK``, else
    the rank modulo the card count) under the ``nccl`` backend; ``"cpu"``
    needs ``gloo``. There is no fallback from one to the other."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in shape)
    need = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a process mesh of shape {shape} needs an initialized process "
            f"group of {need} ranks (torchrun, or "
            "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh shape {shape} needs {need} ranks, the "
                         f"process group has {world}")
    kind = "cuda" if device is None else torch.device(device).type
    backend = dist.get_backend()
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process mesh on the card needs a CUDA "
                               "device; pass device='cpu' (gloo) for one "
                               "on the CPU")
        if backend != "nccl":
            raise ValueError(f"a process mesh on the card needs the nccl "
                             f"backend, the process group has {backend}")
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % n_cards))
        torch.cuda.set_device(local)
        devs = [torch.device("cuda", r % n_cards) for r in range(need)]
        devs[dist.get_rank()] = torch.device("cuda", local)
    elif kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"a process mesh on the CPU needs the gloo "
                             f"backend, the process group has {backend}")
        devs = [torch.device("cpu")] * need
    else:
        raise ValueError(f"no process mesh on device type {kind!r}")
    dm = init_device_mesh(kind, shape, mesh_dim_names=tuple(axes))
    grid = np.empty(need, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks (DP across pods). A process group of
    another size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_process_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2,
                   device: DeviceLike = None) -> Mesh:
    """Small ``(data, model)`` process mesh for tests (four gloo ranks on
    the CPU for the default shape)."""
    return init_process_mesh((data, model), ("data", "model"), device)
