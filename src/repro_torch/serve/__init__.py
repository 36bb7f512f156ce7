"""ClusterKV decode service: plans as first-class serving state.

  session    Session / SessionStore — per-session key plans keyed by spec
  streaming  LockstepInserter — batched insert-tier streaming of generated
             tokens into every (layer, head) plan without re-sorting
  engine     ClusterKVEngine — continuous batching over plan-ordered caches
"""
from repro_torch.serve.session import Session, SessionStore
from repro_torch.serve.engine import ClusterKVEngine

__all__ = ["Session", "SessionStore", "ClusterKVEngine"]
