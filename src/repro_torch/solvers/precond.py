"""Preconditioners factored from the plan's own block-sparse storage.

The ELL-BSR already stores the near-field of the reordered operator as
dense ``bs x bs`` tiles — and on a well-ordered plan (high γ) the
*diagonal* tiles hold most of the interaction mass. Block-Jacobi exploits
exactly that: slice the diagonal tile of every row-block straight out of
the ELL slots (no densification of the off-diagonal storage, no host
round-trip), shift by the solve's regularizer, Cholesky-factor all blocks
in one batched call, and apply each CG iteration as one batched product
with the blocks' inverses.

Factories follow the registry protocol (``repro_torch.core.registry``):

    factory(spec: PlanSpec, data: PlanData, shift) -> apply(r, axis=-1) -> z

``spec``/``data`` are the plan's structure/array halves — a stacked
``PlanBatch`` pair works unchanged (every op here broadcasts over leading
axes), so one factorization preconditions the whole batch. The batched
Cholesky and the per-iteration products are library calls, as they are
XLA operations (no Pallas kernel) in the reference.

Dead slots (streaming tombstones, capacity-padding holes) contribute
zero rows/columns to the operator; the extraction rewrites each dead
slot's diagonal entry to 1 so the factored blocks stay SPD whatever the
shift — the solve then returns ``b/shift``-style values on dead rows,
which the callers zero-pad anyway.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import register_preconditioner

__all__ = ["diag_tiles", "diag_vector", "block_jacobi", "jacobi",
           "identity"]


def _bcast(shift, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-lane ``(B,)`` shift as a float tensor on ``like``'s
    device, with singleton axes appended to broadcast against an ``ndim``
    tensor (lanes lead, structure trails)."""
    s = torch.as_tensor(shift, dtype=like.dtype, device=like.device)
    return s.reshape(s.shape + (1,) * (ndim - s.ndim))


def diag_tiles(spec, data) -> torch.Tensor:
    """Dense diagonal tiles of the plan operator, in cluster order.

    Returns ``(..., n_rb, bs, bs)`` — for each row-block, the kept ELL
    tile whose column-block equals the row-block (zeros when a row-block
    keeps no diagonal tile). Extraction is one masked reduction over the
    ELL slots: the off-diagonal tiles are read, never materialized into
    anything denser. Dead slots (``data.alive``) have their row/column
    zeroed and their diagonal entry set to 1, so the blocks of
    ``A' + shift*I`` are never singular.
    """
    if data.vals is None:
        raise ValueError("profile-only plan (with_bsr=False) has no tiles "
                         "to precondition from")
    n_rb, bs = spec.n_rb, spec.bs
    rb = torch.arange(n_rb, dtype=data.col_idx.dtype,
                      device=data.col_idx.device)
    on_diag = (data.col_idx == rb[:, None]) & data.nbr_mask
    tiles = torch.sum(
        torch.where(on_diag[..., None, None], data.vals, 0.0), dim=-3)
    if data.alive is not None:
        # alive is kept in ORIGINAL slot order (it rides the host mask);
        # the tiles live in cluster order — permute, then pad the
        # capacity -> n_rb*bs structural slots as dead
        alive_cl = torch.gather(data.alive, -1, data.pi.long())
        pad = n_rb * bs - spec.capacity
        if pad:
            alive_cl = torch.nn.functional.pad(alive_cl, (0, pad))
        live = alive_cl.reshape(alive_cl.shape[:-1] + (n_rb, bs)).to(
            tiles.dtype)
        tiles = tiles * live[..., :, None] * live[..., None, :]
        tiles = tiles + (1.0 - live[..., :, None]) * torch.eye(
            bs, dtype=tiles.dtype, device=tiles.device)
    return tiles


def diag_vector(spec, data) -> torch.Tensor:
    """Pointwise diagonal of the plan operator ``(..., capacity)`` —
    the diagonal of :func:`diag_tiles` flattened back to slot order."""
    t = diag_tiles(spec, data)
    d = torch.diagonal(t, dim1=-2, dim2=-1)        # (..., n_rb, bs)
    return d.reshape(d.shape[:-2] + (spec.n_rb * spec.bs,))[
        ..., :spec.capacity]


@register_preconditioner("block_jacobi")
def block_jacobi(spec, data, shift=0.0):
    """Block-Jacobi from the diagonal BSR tiles (batched Cholesky).

    Factors ``D_rb + shift*I`` per row-block in ONE batched
    ``torch.linalg.cholesky_ex`` over every (lane, row-block); ``apply``
    multiplies residual segments reshaped to blocks by the blocks'
    inverses. Requires the tiles to be symmetric positive definite after
    the shift (symmetrized pattern + RBF-style values + a positive shift,
    the KRR setting); a block that is not degrades to Jacobi (below).
    """
    n_rb, bs, cap = spec.n_rb, spec.bs, spec.capacity
    tiles = diag_tiles(spec, data)
    eye = torch.eye(bs, dtype=tiles.dtype, device=tiles.device)
    tiles = tiles + _bcast(shift, tiles.ndim, tiles) * eye
    # cholesky_ex reports a failed block in ``info`` (and leaves a partial
    # factor) where the reference's cholesky returns NaN; with
    # check_errors=False nothing is read back to the host
    L, info = torch.linalg.cholesky_ex(tiles, check_errors=False)
    # a heavily truncated kernel with a small shift can leave a diagonal
    # block indefinite (no Cholesky factor); degrade exactly those blocks
    # to their pointwise-diagonal factor (Jacobi) instead of poisoning the
    # whole solve
    d = torch.diagonal(tiles, dim1=-2, dim2=-1)
    diag_L = torch.sqrt(torch.clamp_min(d, 1e-12))[..., :, None] * eye
    bad = (info != 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    L = torch.where(bad[..., None, None], diag_L, L)
    # invert ONCE at factor time: triangular solves every CG iteration
    # would dominate it; an explicit inverse turns the per-iteration apply
    # into one batched product (symmetric, and preconditioner accuracy is
    # not solution accuracy)
    minv = torch.cholesky_solve(eye.expand(tiles.shape), L)

    def apply(r: torch.Tensor, axis: int = -1) -> torch.Tensor:
        ax = axis % r.ndim - r.ndim
        rr = torch.movedim(r, ax, -1)               # (..., [f,] cap)
        pad = n_rb * bs - cap
        if pad:
            rr = torch.nn.functional.pad(rr, (0, pad))
        blocks = rr.reshape(rr.shape[:-1] + (n_rb, bs))
        if ax == -1:
            zz = torch.einsum("...rij,...rj->...ri", minv, blocks)
        else:
            # (..., f, n_rb, bs): hit every right-hand side of a block
            # with the same inverse in one contraction
            zz = torch.einsum("...rij,...frj->...fri", minv, blocks)
        zz = zz.reshape(rr.shape)[..., :cap]
        return torch.movedim(zz, -1, ax)

    return apply


@register_preconditioner("jacobi")
def jacobi(spec, data, shift=0.0):
    """Pointwise diagonal scaling ``z = r / (diag(A') + shift)`` — the
    plain fallback when the diagonal tiles are not SPD (or ``bs`` is
    large enough that the block solves dominate an iteration)."""
    dv = diag_vector(spec, data)
    d = dv + _bcast(shift, dv.ndim, dv)
    d = torch.where(d == 0, 1.0, d)

    def apply(r: torch.Tensor, axis: int = -1) -> torch.Tensor:
        ax = axis % r.ndim - r.ndim
        if ax == -1:
            return r / d
        return r / d.unsqueeze(-1)

    return apply


@register_preconditioner("identity")
def identity(spec, data, shift=0.0):
    """No preconditioning (plain CG)."""
    del spec, data, shift

    def apply(r: torch.Tensor, axis: int = -1) -> torch.Tensor:
        del axis
        return r

    return apply
