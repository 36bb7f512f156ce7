"""State carried across from the reference package, as numpy arrays.

The port never sees an object of the reference: a caller (the parity tests)
converts the reference plan's state with ``np.asarray`` and hands the
arrays over. ``plan_from_reference_arrays`` rebuilds a working
:class:`~repro_torch.api.InteractionPlan` from them, so both packages can
compute the same ``matvec`` on the same plan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device
from repro_torch.api import (InteractionPlan, PlanConfig, RefreshStats,
                             _PlanHost)
from repro_torch.core.blocksparse import BSR
from repro_torch.core.hierarchy import Tree


# The one two-way map of names that differ between the packages' saved
# state: the reference's SpMV backend ``pallas`` (its TPU kernel) is the
# port's ``cuda`` (its CUDA kernel). Every other name, ``dist`` (sharded)
# among them, is the same in both.
_BACKEND_FROM_REF = {"pallas": "cuda"}
_BACKEND_TO_REF = {v: k for k, v in _BACKEND_FROM_REF.items()}


def backend_from_reference(name: str) -> str:
    """A reference SpMV backend name -> the port's (``pallas`` ->
    ``cuda``)."""
    return _BACKEND_FROM_REF.get(name, name)


def backend_to_reference(name: str) -> str:
    """A port SpMV backend name -> the reference's (``cuda`` -> ``pallas``)."""
    return _BACKEND_TO_REF.get(name, name)


def config_to_reference(config: PlanConfig) -> dict:
    """A port ``PlanConfig`` as the reference's ``dataclasses.asdict``."""
    d = dataclasses.asdict(config)
    d["backend"] = backend_to_reference(d["backend"])
    return d


def array_from_reference(a: np.ndarray):
    """An array a reference checkpoint holds, as the port takes it: a JAX
    bfloat16 array saved by ``np.savez`` loads as 2-byte void (``|V2``),
    whose bits are a bfloat16's; it becomes a ``torch.bfloat16`` tensor
    (no ``ml_dtypes`` needed). Every other array is returned as is."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return a


def bsr_from_arrays(bs: int, sb: int, n: int, col_idx, nbr_mask, vals,
                    fill: float = 0.0, device: DeviceLike = None) -> BSR:
    """A port :class:`BSR` from the arrays of an ELL-BSR: ``col_idx``
    (n_rb, max_nbr) int, ``nbr_mask`` (n_rb, max_nbr) bool, ``vals``
    (n_rb, max_nbr, bs, bs) float.

    The arrays are checked here, once, because the plan path launches the
    SpMV kernel without a per-call check: every ``col_idx`` must lie in
    ``[0, n_rb)``, and every tile under a False ``nbr_mask`` bit must be
    zero (the kernel skips masked slots while the reference sums every
    slot, so only zero tiles there give both one matrix)."""
    dev = resolve_device(device)
    col_idx = np.asarray(col_idx)
    nbr_mask = np.asarray(nbr_mask)
    vals = np.asarray(vals)
    n_rb, max_nbr = col_idx.shape
    if vals.shape != (n_rb, max_nbr, bs, bs):
        raise ValueError(f"vals {vals.shape} does not match col_idx "
                         f"{col_idx.shape} with bs={bs}")
    if nbr_mask.shape != col_idx.shape:
        raise ValueError("nbr_mask and col_idx shapes differ")
    if col_idx.size and (col_idx.min() < 0 or col_idx.max() >= n_rb):
        raise ValueError(f"col_idx outside the {n_rb} column blocks")
    if np.any(vals[~nbr_mask.astype(bool)]):     # NaN counts as nonzero
        raise ValueError("a tile under a False nbr_mask bit is not zero")
    return BSR(bs=bs, sb=sb, n=n, n_rb=n_rb, n_cb=n_rb,
               col_idx=from_numpy(col_idx, dev, torch.int32),
               nbr_mask=from_numpy(nbr_mask, dev, torch.bool),
               vals=from_numpy(vals, dev, torch.float32),
               fill=float(fill), max_nbr=max_nbr)


def plan_from_reference_arrays(
        config: dict, n: int, pi, inv,
        coo: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        col_idx, nbr_mask, vals, sigma: float, *,
        fill: float = 0.0,
        embedding=None, embed_mean=None, embed_axes=None,
        tree_levels: Optional[Sequence[np.ndarray]] = None,
        y_last=None, x=None, sources=None, pattern_from_knn: bool = False,
        values_mode: str = "ones", values_fn: Optional[Callable] = None,
        refresh: Optional[dict] = None, alive=None, codes=None,
        code_lo=None, code_hi=None, peak_alive: Optional[int] = None,
        pending_layout: Optional[str] = None,
        device: DeviceLike = None) -> InteractionPlan:
    """Build a port plan from a reference plan's state.

    ``config`` is the reference ``PlanConfig`` as a dict
    (``dataclasses.asdict``); knobs the port does not know are rejected,
    and its backend crosses through :func:`backend_from_reference`.
    ``coo`` is the reordered ``(rows, cols, vals)`` pattern (or ``None``),
    ``col_idx``/``nbr_mask``/``vals`` the ELL-BSR arrays (all ``None`` for a
    profile-only plan), ``tree_levels`` the tree's per-level boundaries.

    The lifecycle state a refresh reads crosses over too, so a reference
    plan refreshes in the port as it would in the reference: ``y_last``
    (embedding at the last refresh; defaults to ``embedding``), ``x`` and
    ``sources`` (original-order coordinates), ``pattern_from_knn``,
    ``values_mode`` (``ones`` | ``fn`` | ``static``) with ``values_fn`` (the
    reference plan's callable over numpy arrays) and ``refresh``, the
    ``RefreshStats`` fields as a dict (``dataclasses.asdict``); unknown
    fields are rejected.

    So does the streaming state, so that a streamed reference plan goes on
    streaming in the port: ``alive`` (the (n,) row-validity mask; ``None``
    when every slot is live), ``codes`` (the per-slot Morton codes, kept
    ``np.uint64``) with their frozen box ``code_lo``/``code_hi``,
    ``peak_alive`` and ``pending_layout`` (``None``, ``"rebucket"`` or
    ``"compact"``).
    """
    dev = resolve_device(device)
    known = {f.name for f in dataclasses.fields(PlanConfig)}
    unknown = sorted(set(config) - known)
    if unknown:
        raise ValueError(f"unknown PlanConfig knobs {unknown}")
    config = dict(config)
    config["backend"] = backend_from_reference(config.get("backend", "auto"))
    cfg = PlanConfig(**config)
    pi = np.asarray(pi).astype(np.int64)
    inv = np.asarray(inv).astype(np.int64)
    if pi.shape != (n,) or inv.shape != (n,) or \
            not np.array_equal(inv[pi], np.arange(n)):
        raise ValueError("pi/inv are not a permutation pair of length n")
    bsr = None
    if vals is not None:
        bsr = bsr_from_arrays(cfg.bs, cfg.sb, n, col_idx, nbr_mask, vals,
                              fill=fill, device=dev)
    if coo is not None:
        coo = (np.asarray(coo[0]), np.asarray(coo[1]),
               np.asarray(coo[2], np.float32))
    embedding = None if embedding is None else np.asarray(embedding)
    tree = None
    if tree_levels is not None:
        d = embedding.shape[1] if embedding is not None else cfg.d
        tree = Tree(perm=pi, levels=[np.asarray(lv) for lv in tree_levels],
                    d=d, bits=cfg.bits)
    if values_mode not in ("ones", "fn", "static"):
        raise ValueError(f"unknown values_mode {values_mode!r}; expected "
                         "ones | fn | static")
    if values_mode == "fn" and values_fn is None:
        raise ValueError("values_mode 'fn' needs values_fn")
    if pending_layout not in (None, "rebucket", "compact"):
        raise ValueError(f"unknown pending layout tier {pending_layout!r}")
    if alive is not None:
        alive = np.asarray(alive, bool)
        if alive.shape != (n,):
            raise ValueError(f"alive has shape {alive.shape}, expected "
                             f"({n},)")
    if codes is not None:
        codes = np.asarray(codes).astype(np.uint64)
        if codes.shape != (n,):
            raise ValueError(f"codes has shape {codes.shape}, expected "
                             f"({n},)")

    def arr(a, dtype=None):
        return None if a is None else np.asarray(a, dtype)

    host = _PlanHost(
        pi=pi, inv=inv, coo=coo, tree=tree, embedding=embedding,
        sigma=float(sigma), embed_mean=arr(embed_mean),
        embed_axes=arr(embed_axes),
        y_last=embedding if y_last is None else np.asarray(y_last),
        x=arr(x, np.float32), sources=arr(sources, np.float32),
        pattern_from_knn=bool(pattern_from_knn), values_mode=values_mode,
        values_fn=values_fn, alive=alive, codes=codes,
        code_lo=arr(code_lo), code_hi=arr(code_hi),
        peak_alive=None if peak_alive is None else int(peak_alive),
        pending_layout=pending_layout)
    if refresh is None:
        host.refresh.fill0 = bsr.fill if bsr is not None else None
    else:
        known = {f.name for f in dataclasses.fields(RefreshStats)}
        unknown = sorted(set(refresh) - known)
        if unknown:
            raise ValueError(f"unknown RefreshStats fields {unknown}")
        host.refresh = RefreshStats(**refresh)
    return InteractionPlan(cfg, n, bsr, from_numpy(pi, dev, torch.int64),
                           from_numpy(inv, dev, torch.int64), host)


# ---------------------------------------------------------------------------
# model parameters and configs
# ---------------------------------------------------------------------------

# fields renamed in the port: reference name -> (port name, value map).
# The reference's choices pick a TPU path; in the port the device picks it
# (the CUDA kernels on a CUDA tensor, their plain versions on the CPU), so
# every known value crosses as "auto".
_CKV_RENAMES = {
    "use_pallas": ("use_kernel", {True: "auto", False: "auto"}),
    "decode_backend": ("decode_backend",
                       {"xla": "auto", "pallas": "auto", "auto": "auto"}),
}


def config_from_reference(cfg):
    """A port ``ModelConfig`` from a reference ``ModelConfig`` (the
    dataclass itself or ``dataclasses.asdict`` of it). Maps the two fields
    the port renames: ``clusterkv.use_pallas`` -> ``use_kernel`` and
    ``decode_backend``, each to ``"auto"`` whatever the reference chose
    (see ``_CKV_RENAMES``); unknown fields and values are rejected."""
    from repro_torch.configs import base

    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    ckv = dict(d.get("clusterkv") or {})
    for old, (new, values) in _CKV_RENAMES.items():
        if old in ckv:
            v = ckv.pop(old)
            if v not in values:
                raise ValueError(f"clusterkv.{old}={v!r} has no counterpart "
                                 f"in the port (known: {sorted(map(str, values))})")
            ckv[new] = values[v]
    nested = {"clusterkv": base.ClusterKVConfig, "moe": base.MoEConfig,
              "ssm": base.SSMConfig, "mla": base.MLAConfig}
    out = {}
    known = {f.name for f in dataclasses.fields(base.ModelConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown ModelConfig fields {unknown}")
    for key, val in d.items():
        if key in nested and val is not None:
            val = ckv if key == "clusterkv" else val
            fields = {f.name for f in dataclasses.fields(nested[key])}
            bad = sorted(set(val) - fields)
            if bad:
                raise ValueError(f"unknown {key} fields {bad}")
            val = nested[key](**val)
        out[key] = val
    return base.ModelConfig(**out)


def params_from_reference(params_np, cfg, device: DeviceLike = None) -> dict:
    """The port's parameters from a reference parameter tree.

    ``params_np`` is the reference tree with every leaf as a numpy array
    (``jax.tree.map(np.asarray, params)``): ``pm.linear``'s ``(d_in, d_out)``
    weights, stacked ``(L, ...)`` layers, a tied head. The port keeps that
    layout, so the tree crosses leaf for leaf, as float32 tensors on
    ``device``; every leaf's shape is checked against the port's own
    initialisation of ``cfg`` (built on the ``meta`` device, no memory).
    """
    from repro_torch.models import model_api

    dev = resolve_device(device)
    want = model_api.module_for(cfg).init_lm(
        cfg, torch.Generator(device="cpu"), device="meta")

    def cross(ref, shape_tree, path):
        if isinstance(shape_tree, dict):
            if not isinstance(ref, dict) or set(ref) != set(shape_tree):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"parameter tree at {path or '/'} has keys "
                                 f"{got}, expected {sorted(shape_tree)}")
            return {k: cross(ref[k], shape_tree[k], f"{path}/{k}")
                    for k in shape_tree}
        arr = np.asarray(ref)
        if tuple(arr.shape) != tuple(shape_tree.shape):
            raise ValueError(f"parameter {path}: shape {arr.shape}, expected "
                             f"{tuple(shape_tree.shape)}")
        return from_numpy(arr, dev, torch.float32)

    return cross(params_np, want, "")


def opt_state_from_reference(state_np, params, opt) -> dict:
    """The port's optimizer state from a reference optimizer state.

    ``state_np`` is the reference's ``opt.init``/``opt.update`` state with
    every leaf a numpy array (``jax.tree.map(np.asarray, state)``):
    AdamW's ``{"m", "v", "step"}`` or Adafactor's ``{"v", "step"}`` (a
    ``{"vr", "vc"}`` or ``{"v"}`` dict per parameter). ``opt`` is the
    port's optimizer of the same kind and ``params`` the port's parameters
    it updates; the state comes out as ``opt.init(params)`` lays it out,
    every key and shape checked, the moments float32 and ``step`` int32 on
    the parameters' device. With ``params_from_reference`` a reference
    training state crosses over whole."""
    from repro_torch.models.param import tree_leaves, tree_map

    dev = tree_leaves(params)[0].device
    want = opt.init(tree_map(lambda p: torch.empty_like(p, device="meta"),
                             params))

    def cross(ref, shape_tree, path):
        if isinstance(shape_tree, dict):
            if not isinstance(ref, dict) or set(ref) != set(shape_tree):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"optimizer state at {path or '/'} has keys "
                                 f"{got}, expected {sorted(shape_tree)}")
            return {k: cross(ref[k], shape_tree[k], f"{path}/{k}")
                    for k in shape_tree}
        arr = np.asarray(ref)
        if tuple(arr.shape) != tuple(shape_tree.shape):
            raise ValueError(f"optimizer state {path}: shape {arr.shape}, "
                             f"expected {tuple(shape_tree.shape)}")
        # (from_numpy makes a 0-d array 1-d)
        return from_numpy(arr, dev, shape_tree.dtype).reshape(arr.shape)

    return cross(state_np, want, "")
