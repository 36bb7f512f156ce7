"""Persistence of model trees, plans, plan batches and session stores
(the reference's on-disk format; see :mod:`repro_torch.checkpoint.ckpt`)."""
from repro_torch.checkpoint.ckpt import Checkpointer

__all__ = ["Checkpointer"]
