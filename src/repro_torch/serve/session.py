"""Sessions and the spec-keyed session store.

A serving *session* is one in-flight request plus its plan assets: one
ordering ``PlanBatch`` per layer (members = kv heads) over the session's
keys, built once at prefill with ``capacity=max_seq`` and thereafter
maintained by the insert tier — never re-sorted per token.

The ``SessionStore`` keys sessions by their shared
:class:`~repro_torch.api.PlanSpec`. Because every session is built to the
same capacity and plan config, spec-identical sessions share ONE decode
step input signature (the shapes a compiled or graph-captured decode would
be keyed on) — the store's ``specs_seen`` set is the "how many decode
signatures did admission cost" ledger the service gates on.

A copy of the reference's ``repro.serve.session``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np


@dataclasses.dataclass
class Session:
    rid: int                      # request id
    slot: int                     # engine slot currently hosting it
    blen: int                     # prefill bucket length (prompt positions)
    plans: List                   # one ordering PlanBatch per layer
    # time position -> (L, Hkv) physical plan rows of the generated token
    phys_hist: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # snapshot payload (device rows, pending token, request state) — filled
    # by ClusterKVEngine.snapshot, consumed by resume
    aux: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def spec(self):
        return self.plans[0].spec


class SessionStore:
    """Live sessions, their shared specs, and service counters."""

    def __init__(self):
        self.sessions: Dict[int, Session] = {}
        self._spec_rids: Dict[object, Set[int]] = {}
        self.seen_specs: Set[object] = set()
        self.counters: Dict[str, int] = {
            "admits": 0, "retires": 0, "evictions": 0,
            "inserts": 0, "deletes": 0, "rebuckets": 0, "flushed_edges": 0,
        }

    # -- membership ---------------------------------------------------------

    def register(self, sess: Session) -> bool:
        """Track a session without counting an admission (restore path).
        Returns True when its spec is NEW to this store — i.e. admitting
        it would have compiled a fresh kernel family."""
        fresh = sess.spec not in self.seen_specs
        self.seen_specs.add(sess.spec)
        self._spec_rids.setdefault(sess.spec, set()).add(sess.rid)
        self.sessions[sess.rid] = sess
        return fresh

    def admit(self, sess: Session) -> bool:
        fresh = self.register(sess)
        self.counters["admits"] += 1
        return fresh

    def retire(self, rid: int, evict: bool = False) -> Session:
        sess = self.sessions.pop(rid)
        rids = self._spec_rids.get(sess.spec)
        if rids is not None:
            rids.discard(rid)
            if not rids:
                del self._spec_rids[sess.spec]
        self.counters["evictions" if evict else "retires"] += 1
        return sess

    def get(self, rid: int) -> Optional[Session]:
        return self.sessions.get(rid)

    # -- telemetry ----------------------------------------------------------

    @property
    def specs_live(self) -> int:
        return len(self._spec_rids)

    @property
    def specs_seen(self) -> int:
        return len(self.seen_specs)

    def report(self) -> dict:
        return {
            "active_sessions": len(self.sessions),
            "specs_live": self.specs_live,
            "specs_seen": self.specs_seen,
            "counters": dict(self.counters),
        }
