"""Continuous-batching serving loop.

A fixed pool of ``slots`` (the static decode batch), a request queue, and an
engine loop that

  - admits queued requests into free slots (prefilling the prompt, left
    padded to a multiple of ``prefill_bucket``, into the slot's cache
    region),
  - runs ONE batched decode step for all slots per tick, every slot writing
    and masking at its own position,
  - retires slots on EOS/max-tokens and backfills them at the next tick.

Everything runs eagerly (the reference jit-compiles the decode step once
and the prefill once per bucket). The engine keeps host-clock timings of
each prefill and each tick in ``timings``; both end on a device-to-host
read of the argmax, so they include the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # prompt token ids (1-D)
    max_new: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_seq: int = 512, prefill_bucket: int = 64,
                 backend: str = "flash", device: DeviceLike = None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                "the engine serves decoder-only token models (the dense "
                "and moe families), as the reference's")
        if cfg.mla is not None:
            raise NotImplementedError(
                "the engine does not serve MLA: continuous batching decodes "
                "at per-slot positions, and MLA's absorbed decode takes a "
                "scalar position only (as the reference's)")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.bucket = prefill_bucket
        self.backend = backend
        self.device = resolve_device(device)
        mod = model_api.module_for(cfg)
        self.mod = mod
        self.cache = mod.init_cache(cfg, slots, max_seq, device=self.device)
        # per-slot positions replace the scalar cache pos
        self.slot_pos = np.zeros(slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        # which axis of each cache entry is the sequence axis, read off the
        # family's own cache layout (slot install copies along it)
        self._seq_axes = model_api.cache_seq_axes(cfg)
        self.ticks = 0
        self.timings = {"prefill_s": [], "tick_s": []}
        self.first_logits = {}         # rid -> first-token logits (host)

    # -- engine -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.t_submit = time.time()
        self.queue.append(req)

    def _decode_step(self, params, cache, tokens, slot_pos):
        """One token for every slot, each writing and masking at ITS OWN
        position (``cache['pos']`` as a (slots,) vector — decode_step's
        continuous-batching contract)."""
        return self.mod.decode_step(params, self.cfg,
                                    dict(cache, pos=slot_pos), tokens,
                                    self.backend)

    def _install(self, s: int, req: Request, cache_1, blen: int):
        """Install an admitted request's prefilled state into slot ``s``.

        The base engine copies every seq-scaling cache entry (along its
        sequence axis) into the slot's cache region. Subclasses may stage
        entirely different serving state and return replacement
        first-token logits (else None to keep the prefill's)."""
        for key, ax in self._seq_axes.items():
            seg = cache_1[key][:, 0]             # e.g. (L, H, blen, dh)
            dst = self.cache[key].select(1, s)   # slot on the batch axis
            dst.narrow(ax - 1, 0, blen).copy_(seg)
        return None

    def _release(self, s: int, req: Request) -> None:
        """Hook: slot ``s`` just retired ``req``."""

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            plen = len(req.tokens)
            blen = -(-plen // self.bucket) * self.bucket
            if blen > self.max_seq:
                raise ValueError(f"prompt of {plen} tokens needs a "
                                 f"{blen}-token bucket > max_seq="
                                 f"{self.max_seq}")
            padded = np.zeros(blen, np.int64)
            padded[-plen:] = req.tokens          # left-pad into the bucket
            t0 = time.perf_counter()
            cache_1, logits = self.mod.prefill(
                self.params, self.cfg,
                {"tokens": torch.from_numpy(padded[None]).to(self.device)},
                self.backend)
            override = self._install(s, req, cache_1, blen)
            if override is not None:
                logits = override
            tok = int(torch.argmax(logits[0]))
            self.timings["prefill_s"].append(time.perf_counter() - t0)
            self.first_logits[req.rid] = logits[0].cpu()
            self.slot_pos[s] = blen
            req.output.append(tok)
            req.t_first = time.time()
            self.slot_req[s] = req

    def _retire(self) -> None:
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            done = (len(req.output) >= req.max_new
                    or (req.eos_id is not None
                        and req.output[-1] == req.eos_id)
                    or int(self.slot_pos[s]) >= self.max_seq - 1)
            if done:
                req.t_done = time.time()
                self.slot_req[s] = None
                self.slot_pos[s] = 0
                self._release(s, req)

    def step(self) -> int:
        """One engine tick: admit, decode all slots, advance the active."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].output[-1]
        t0 = time.perf_counter()
        logits, new_cache = self._decode_step(
            self.params, self.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.slot_pos.copy()).to(self.device))
        self.cache = dict(new_cache, pos=self.cache["pos"])
        nxt = torch.argmax(logits, -1).cpu().numpy()
        self.timings["tick_s"].append(time.perf_counter() - t0)
        for s in active:
            self.slot_pos[s] += 1
            self.slot_req[s].output.append(int(nxt[s]))
        self.ticks += 1
        return len(active)

    def run(self, max_ticks: int = 10_000) -> None:
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.ticks < max_ticks:
            self.step()
            self._retire()
