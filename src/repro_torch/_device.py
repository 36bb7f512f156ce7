"""Device and dtype resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device with no card raises —
    the port never carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly for the plain "
            "PyTorch paths")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(a, device: DeviceLike = None) -> torch.device:
    """The device a computation on ``a`` runs on: ``device`` when given,
    else a tensor's own device, else the default (``"cuda"``)."""
    if device is None and isinstance(a, torch.Tensor):
        return a.device
    return resolve_device(device)


def from_numpy(a, device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Array-like (numpy array, list, or tensor) -> tensor on ``device``.

    A tensor is moved (and cast) but never copied needlessly; a numpy
    array is copied once so the tensor never aliases caller memory."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype or a.dtype)
    # reversed views (negative strides) and read-only arrays are not
    # tensor material as they stand: make them contiguous first
    arr = np.ascontiguousarray(a)
    if dev.type == "cpu" or not arr.flags.writeable:
        t = torch.tensor(arr)                      # always a copy
    else:
        t = torch.from_numpy(arr)
    return t.to(device=dev, dtype=dtype or t.dtype)


def to_numpy(t) -> np.ndarray:
    """Tensor (any device) or array-like -> numpy array on the host."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
