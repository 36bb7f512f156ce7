"""SpMV backend registry — the pluggable compute layer of an InteractionPlan.

A backend is a callable

    fn(plan: InteractionPlan, x: torch.Tensor, **kwargs) -> torch.Tensor

computing ``y = A x`` in the plan's (cluster-ordered) index space. Built-in
backends register themselves on first use:

  csr       per-edge gather baseline           (core.interact, needs COO)
  bsr       flat single-level block path       (core.interact)
  bsr_ml    multi-level superblock stripes     (core.interact)
  cuda      hand-written ELL-BSR CUDA kernel   (kernels.ops; the
            counterpart of the reference's ``pallas`` backend)

``csr``/``bsr``/``bsr_ml`` are the plain PyTorch reference paths that stand
beside the kernel; they run on any device. ``cuda`` launches the kernel
for a plan on the card and uses its plain version for a plan on the CPU.
User code can ``register_backend`` custom paths and they become visible to
``plan.apply`` immediately. The decode-attention backends of ClusterKV
have a registry of their own at the end of this module.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_BACKENDS: Dict[str, Callable] = {}
_BATCHED: Dict[str, Callable] = {}
_DEFAULTS_LOADED = False

# modules that register the built-in backends at import time
_DEFAULT_PROVIDERS = ("repro_torch.core.interact", "repro_torch.kernels.ops")

# preconditioner names PlanConfig validates against; the factories
# themselves arrive with the solver subsystem
PRECONDITIONERS: Tuple[str, ...] = ("block_jacobi", "jacobi", "identity")


def register_backend(name: str, fn: Callable | None = None, *,
                     overwrite: bool = False):
    """Register ``fn`` as SpMV backend ``name`` (usable as a decorator).

    Re-registering an existing name raises unless ``overwrite=True`` —
    a silent overwrite turns two libraries picking the same name into a
    wrong-answer bug instead of an import-time error. Re-registering the
    *same* callable is a no-op (module re-imports are harmless).
    """

    def _register(f: Callable) -> Callable:
        prev = _BACKENDS.get(name)
        if prev is not None and prev is not f and not overwrite:
            raise ValueError(
                f"SpMV backend {name!r} is already registered "
                f"({prev.__module__}.{prev.__qualname__}); pass "
                "overwrite=True to replace it deliberately")
        _BACKENDS[name] = f
        return f

    return _register if fn is None else _register(fn)


def register_batched_backend(name: str, fn: Callable | None = None, *,
                             overwrite: bool = False):
    """Register the *batched* implementation of backend ``name``.

    A batched backend is ``fn(spec: PlanSpec, data: PlanData, xs) -> ys``
    computing the cluster-order interaction for a whole stacked batch
    (leading axis) in one call.
    """

    def _register(f: Callable) -> Callable:
        prev = _BATCHED.get(name)
        if prev is not None and prev is not f and not overwrite:
            raise ValueError(
                f"batched SpMV backend {name!r} is already registered; "
                "pass overwrite=True to replace it deliberately")
        _BATCHED[name] = f
        return f

    return _register if fn is None else _register(fn)


def get_batched_backend(name: str) -> Callable | None:
    """The batched implementation of ``name``, or ``None`` when the
    backend only has a single-plan path."""
    _ensure_defaults()
    return _BATCHED.get(name)


def _ensure_defaults() -> None:
    global _DEFAULTS_LOADED
    if _DEFAULTS_LOADED:
        return
    import importlib

    for mod in _DEFAULT_PROVIDERS:
        importlib.import_module(mod)
    # only latch after every provider imported: a transient import failure
    # surfaces on this call and is retried on the next, instead of leaving
    # a silently partial registry
    _DEFAULTS_LOADED = True


def get_backend(name: str) -> Callable:
    _ensure_defaults()
    try:
        return _BACKENDS[name]
    except KeyError:
        import difflib

        close = difflib.get_close_matches(name, backend_names(), n=1,
                                          cutoff=0.5)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown SpMV backend {name!r}{hint}; "
            f"registered: {backend_names()}"
        ) from None


def backend_names() -> Tuple[str, ...]:
    _ensure_defaults()
    return tuple(sorted(_BACKENDS))


def preconditioner_names() -> Tuple[str, ...]:
    return tuple(sorted(PRECONDITIONERS))


# ---------------------------------------------------------------------------
# decode-attention backends
# ---------------------------------------------------------------------------
#
# A decode backend is
#
#     fn(q, ks, vs, ps, cent, qpos, cfg, *, k_self=None, v_self=None) -> out
#
# computing ``clusterkv_plan_decode``'s contract over plan-ordered caches
# (see models.attention). Built-ins:
#
#   plain    top-k select + tile gather + attend in plain PyTorch (the
#            counterpart of the reference's ``xla``)
#   cuda     the hand-written fused kernel (kernels.decode_attend; the
#            counterpart of ``pallas``): selection, gather and softmax in
#            one launch
#
# ``cfg.decode_backend == "auto"`` resolves to ``cuda`` for a CUDA tensor
# and ``plain`` on the CPU (the cost model that ranks them is ROADMAP A9).

_DECODE: Dict[str, Callable] = {}
_DECODE_LOADED = False
_DECODE_PROVIDERS = ("repro_torch.models.attention", "repro_torch.kernels.ops")


def register_decode_backend(name: str, fn: Callable | None = None, *,
                            overwrite: bool = False):
    """Register ``fn`` as decode-attention backend ``name`` (decorator-friendly)."""

    def _register(f: Callable) -> Callable:
        prev = _DECODE.get(name)
        if prev is not None and prev is not f and not overwrite:
            raise ValueError(
                f"decode backend {name!r} is already registered "
                f"({prev.__module__}.{prev.__qualname__}); pass "
                "overwrite=True to replace it deliberately")
        _DECODE[name] = f
        return f

    return _register if fn is None else _register(fn)


def _ensure_decode_defaults() -> None:
    global _DECODE_LOADED
    if _DECODE_LOADED:
        return
    import importlib

    for mod in _DECODE_PROVIDERS:
        importlib.import_module(mod)
    _DECODE_LOADED = True


def get_decode_backend(name: str) -> Callable:
    _ensure_decode_defaults()
    try:
        return _DECODE[name]
    except KeyError:
        import difflib

        close = difflib.get_close_matches(name, decode_backend_names(), n=1,
                                          cutoff=0.5)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown decode backend {name!r}{hint}; "
            f"registered: {decode_backend_names()}"
        ) from None


def decode_backend_names() -> Tuple[str, ...]:
    _ensure_decode_defaults()
    return tuple(sorted(_DECODE))
