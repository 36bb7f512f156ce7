"""Mamba blocks: the mamba1 selective scan (falcon-mamba) and the mamba2
SSD (zamba2), in chunked forms, as the reference's ``models/mamba.py``.

The recurrence is evaluated chunk by chunk. Within a chunk, mamba1 scans
with a log-step (Hillis-Steele) scan of the reference's associative combine
``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``: ``log2(chunk)`` doubling
steps of whole-chunk tensor ops, where the reference calls
``lax.associative_scan``; mamba2 uses the SSD matmul form (dense (l x l)
decay kernels). Across chunks a Python loop carries the state, where the
reference runs ``lax.scan``. The reference's scans are plain XLA (no
Pallas kernel), so these are plain PyTorch. Float32 sums are taken in
another order than XLA's, so results agree within rounding, not bit for
bit.

The conv weight keeps the reference's ``(width, 1, C)`` layout (a reference
tree crosses over leaf for leaf) and is transposed at apply time.

Under a tensor split (``split``, a process mesh's ``tp``: the reference's
specs split the inner dim) a block computes this rank's inner channels
(mamba1) or heads (mamba2) with the weights' blocks ``compute_specs``
names: the input projections' columns, the conv, ``dt``, ``A_log`` and
``D`` of its channels, the scan on them alone, and the output projection's
rows summed over the split. mamba1's ``x_proj`` rows give partial sums of
``dt``/``B``/``C`` summed over the split (``TensorSplit.total``); mamba2's
``B``/``C`` projection and conv stay whole, as the reference's, and its
gated norm sums its squares over the split.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm
from repro_torch.models import sharding
from repro_torch.models.sharding import NO_SHARD, ShardCtx


def _dims(cfg: ModelConfig):
    """(d_inner, dt_rank, d_state) of the config's SSM."""
    m = cfg.ssm
    d = cfg.d_model
    return m.expand * d, m.dt_rank or -(-d // 16), m.d_state


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------


def conv1d_init(channels: int, width: int, tp: str = "tp") -> dict:
    """Depthwise conv weights; ``tp=None`` leaves the channels unsharded."""
    return {"w": pm.normal((width, 1, channels), 1.0 / math.sqrt(width),
                           (None, None, tp)),
            "b": pm.Init((channels,), spec=(tp,))}


def conv1d_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), causal depthwise conv (left padding ``width - 1``)."""
    width, _, c = p["w"].shape
    w = p["w"].to(x.dtype).permute(2, 1, 0)              # (C, 1, width)
    y = F.conv1d(F.pad(x.transpose(1, 2), (width - 1, 0)), w, groups=c)
    return y.transpose(1, 2) + p["b"].to(x.dtype)


def conv1d_step(p: dict, buf: torch.Tensor, x1: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode: buf (B, width-1, C) history, x1 (B, 1, C) new token. The
    window and the output take the promoted dtype of the two (a float32
    buffer with bf16 tokens gives float32, as in the reference)."""
    dt = torch.promote_types(buf.dtype, x1.dtype)
    window = torch.cat([buf.to(dt), x1.to(dt)], dim=1)   # (B, width, C)
    w = p["w"][:, 0, :].to(x1.dtype)                     # (width, C)
    y = torch.einsum("bwc,wc->bc", window, w.to(dt)) \
        + p["b"].to(x1.dtype).to(dt)
    return window[:, 1:], y[:, None]


# ---------------------------------------------------------------------------
# mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------


def init_mamba1(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, dt_rank, n = _dims(cfg)
    return {"in_proj": pm.linear(d, 2 * di, spec=("fsdp", "tp")),
            "conv": conv1d_init(di, cfg.ssm.d_conv),
            "x_proj": pm.linear(di, dt_rank + 2 * n, spec=("tp", None)),
            "dt_proj": pm.linear(dt_rank, di, spec=(None, "tp"), bias=True),
            # log(1..N) on every inner channel, D = 1: constants, no draw
            "A_log": pm.constant((di, n), np.log(np.arange(1, n + 1)),
                                 ("tp", None)),
            "D": pm.Init((di,), fill=1.0, spec=("tp",)),
            "out_proj": pm.linear(di, d, spec=("tp", "fsdp"))}


def _scan_chunk(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along axis 1 of the combine ``(a1, b1), (a2, b2) ->
    (a2 a1, a2 b1 + b2)``, returning its ``b`` part: Hillis-Steele,
    ``ceil(log2(l))`` doubling steps, each written into the other half of
    a ping-pong pair of buffers (no concatenation, and the ``a`` part is
    not formed after the last step, where nothing reads it). Overwrites
    ``da`` and ``dbx``."""
    l = da.shape[1]
    a, b = da, dbx
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    k = 1
    while k < l:
        b2[:, :k].copy_(b[:, :k])
        torch.addcmul(b[:, k:], a[:, k:], b[:, :-k], out=b2[:, k:])
        b, b2 = b2, b
        if 2 * k < l:
            a2[:, :k].copy_(a[:, :k])
            torch.mul(a[:, k:], a[:, :-k], out=a2[:, k:])
            a, a2 = a2, a
        k *= 2
    return b


def _pad_time(chunk: int, *ts):
    """Each (B,S,*) tensor zero-padded along S to whole chunks."""
    s = ts[0].shape[1]
    pad = -(-s // chunk) * chunk - s
    return tuple(F.pad(t, (0, 0, 0, pad)) if pad else t for t in ts)


def _scan_forward(xc, dt, a_mat, bc, cc, chunk: int, starts=None):
    """The chunked forward over inputs already padded to whole chunks:
    y (B,S,di) and the final state. ``starts`` (a list), when given,
    receives the state each chunk starts from."""
    b, s, di = xc.shape
    n = a_mat.shape[-1]
    h = torch.zeros((b, di, n), dtype=xc.dtype, device=xc.device)
    ys = []
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if starts is not None:
            starts.append(h)
        dtc = dt[:, sl, :, None]                         # (B,l,di,1)
        da = torch.exp(dtc * a_mat)                      # (B,l,di,N)
        dbx = dtc * bc[:, sl, None, :] * xc[:, sl, :, None]
        dbx[:, 0].addcmul_(da[:, 0], h)
        hs = _scan_chunk(da, dbx)                        # (B,l,di,N)
        ys.append(torch.einsum("bldn,bln->bld", hs, cc[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h.clone()   # not a view pinning the chunk


class _SelectiveScan(torch.autograd.Function):
    """The chunked scan with its adjoint. The forward keeps only the state
    each chunk starts from; the backward walks the chunks last to first,
    recomputes a chunk's states from its start, and runs the adjoint of
    ``h_t = a_t h_{t-1} + b_t``, which is the same recurrence backwards:
    ``lam_t = dL/dh_t + a_{t+1} lam_{t+1}``, ``dL/db_t = lam_t``,
    ``dL/da_t = lam_t h_{t-1}``. It runs through ``_scan_chunk`` on the
    chunk flipped in time, the adjoint carried in from the next chunk
    entering as the first term, as the forward carries its state."""

    @staticmethod
    def forward(ctx, xc, dt, a_mat, bc, cc, chunk):
        s = xc.shape[1]
        xc, dt, bc, cc = _pad_time(chunk, xc, dt, bc, cc)
        starts = []
        y, h = _scan_forward(xc, dt, a_mat, bc, cc, chunk, starts)
        ctx.save_for_backward(xc, dt, a_mat, bc, cc, torch.stack(starts))
        ctx.chunk, ctx.s = chunk, s
        return y[:, :s], h

    @staticmethod
    def backward(ctx, gy, gh):
        xc, dt, a_mat, bc, cc, starts = ctx.saved_tensors
        chunk, s = ctx.chunk, ctx.s
        gy = F.pad(gy, (0, 0, 0, xc.shape[1] - s)) if gy is not None \
            else torch.zeros_like(xc)
        # the adjoint carried into a chunk from the one after it, already
        # multiplied by that chunk's first decay: dL/dh_fin for the last
        carry = gh if gh is not None else torch.zeros_like(starts[0])
        gxs, gdts, gbs, gcs = [], [], [], []
        ga = torch.zeros_like(a_mat)
        for c in reversed(range(starts.shape[0])):
            sl = slice(c * chunk, (c + 1) * chunk)
            dtc, xcc = dt[:, sl], xc[:, sl]
            bcc, ccc, gyc = bc[:, sl], cc[:, sl], gy[:, sl]
            da = torch.exp(dtc[..., None] * a_mat)       # (B,l,di,N)
            dbx = dtc[..., None] * bcc[:, :, None, :] * xcc[..., None]
            dbx[:, 0].addcmul_(da[:, 0], starts[c])
            hs = _scan_chunk(da.clone(), dbx)            # states, (B,l,di,N)
            prev = torch.cat([starts[c][:, None], hs[:, :-1]], dim=1)
            # the adjoint, flipped in time: a_s = da_{l-s} (a_0 unread)
            rev_a = torch.cat([torch.ones_like(da[:, :1]),
                               da.flip(1)[:, :-1]], dim=1)
            rev_g = (gyc[..., None] * ccc[:, :, None, :]).flip(1)
            rev_g[:, 0].add_(carry)
            lam = _scan_chunk(rev_a, rev_g).flip(1)      # dL/dh_t
            carry = da[:, 0] * lam[:, 0]
            gda = lam * prev * da                        # dL/d(dt A)
            ga += torch.einsum("bldn,bld->dn", gda, dtc)
            lb = torch.einsum("bldn,bln->bld", lam, bcc)
            gdts.append(torch.einsum("bldn,dn->bld", gda, a_mat) + lb * xcc)
            gxs.append(lb * dtc)
            gbs.append(torch.einsum("bldn,bld->bln", lam, dtc * xcc))
            gcs.append(torch.einsum("bld,bldn->bln", gyc, hs))

        def whole(parts):
            return torch.cat(parts[::-1], dim=1)[:, :s]
        return whole(gxs), whole(gdts), ga, whole(gbs), whole(gcs), None


def selective_scan(xc, dt, a_mat, bc, cc, chunk: int):
    """Chunked mamba1 scan.

    xc/dt (B,S,di); a_mat (di,N); bc/cc (B,S,N). Returns y (B,S,di) and the
    final state (B,di,N). The (B, chunk, di, N) decay and input terms are
    formed one chunk at a time (never for the whole sequence), and the
    state carried in from the previous chunk enters as the chunk's first
    input term (``h_0 = a_0 h + b_0``), so the scan's ``b`` part is the
    state at every position: the reference's ``acum * h + bcum``, in
    another order of float32 rounding.

    The chunk buffers are written in place, which autograd cannot follow:
    where grad mode is on and an input requires grad, the scan runs as
    :class:`_SelectiveScan`, whose backward is the adjoint recurrence (the
    reference differentiates its ``lax.associative_scan``); the values are
    the same either way."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, a_mat, bc, cc)):
        return _SelectiveScan.apply(xc, dt, a_mat, bc, cc, chunk)
    s = xc.shape[1]
    y, h = _scan_forward(*_pad_time(chunk, xc, dt), a_mat,
                         *_pad_time(chunk, bc, cc), chunk)
    return y[:, :s], h


def inner_split(cfg: ModelConfig, split):
    """``split`` where it takes the mamba layers' inner dim (None without
    one): mamba1's channels and mamba2's heads must divide over it, else
    it raises, naming the count."""
    if split is None:
        return None
    di, _, _ = _dims(cfg)
    count, what = ((di // cfg.ssm.head_dim, "mamba2 heads")
                   if cfg.ssm.version == 2 else (di, "mamba1 inner channels"))
    if count % split.n:
        raise ValueError(f"{count} {what} do not split over the "
                         f"{split.n}-way {split.axis!r} axis")
    return split


def compute_specs(cfg: ModelConfig, split) -> dict:
    """Compute specs of a stacked mamba block's weights under ``split``
    (``inner_split``'s): this rank's channels (or heads) of every leaf the
    reference splits over ``tp``, plus mamba2's per-head ``dt_proj``
    columns, ``dt_bias`` and gated-norm scale, which it computes with its
    heads alone; the rest whole."""
    di, _, _ = _dims(cfg)
    if cfg.ssm.version == 1:
        lo, hi = split.block(di)
        return {"in_proj": {"w": sharding.Part(
                    None, None, None, axis=split.axis, dim=2,
                    blocks=((lo, hi), (di + lo, di + hi)))},
                "conv": {"w": split.spec(4, 3, di), "b": split.spec(2, 1, di)},
                "x_proj": {"w": split.spec(3, 1, di)},
                "dt_proj": {"w": split.spec(3, 2, di),
                            "b": split.spec(2, 1, di)},
                "A_log": split.spec(3, 1, di), "D": split.spec(2, 1, di),
                "out_proj": {"w": split.spec(3, 1, di)}}
    nh = di // cfg.ssm.head_dim
    return {"z_proj": {"w": split.spec(3, 2, di)},
            "x_proj": {"w": split.spec(3, 2, di)},
            "dt_proj": {"w": split.spec(3, 2, nh)},
            "conv_x": {"w": split.spec(4, 3, di), "b": split.spec(2, 1, di)},
            "A_log": split.spec(2, 1, nh), "D": split.spec(2, 1, nh),
            "dt_bias": split.spec(2, 1, nh),
            "norm": {"scale": split.spec(2, 1, di)},
            "out_proj": {"w": split.spec(3, 1, di)}}


def mamba1_forward(lp, x, cfg: ModelConfig, shd: ShardCtx = NO_SHARD,
                   split=None):
    """One mamba1 block (the caller adds the residual). x (B,S,d). Returns
    (out, final state (B,di,N) float32, conv buffer (B,width-1,di)); under
    a tensor ``split`` (``inner_split``) the state and buffer hold this
    rank's channels."""
    m = cfg.ssm
    _, dt_rank, n = _dims(cfg)
    di = lp["A_log"].shape[0]                  # this rank's channels
    if split is not None:
        x = split.enter(x)
    xz = pm.apply_linear(lp["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    xin = shd.cst(xin, "dp", None, "tp")
    xc = F.silu(conv1d_apply(lp["conv"], xin))
    proj = pm.apply_linear(lp["x_proj"], xc)
    if split is not None:
        proj = split.total(proj)
    dt = F.softplus(pm.apply_linear(lp["dt_proj"], proj[..., :dt_rank]))
    bc = proj[..., dt_rank:dt_rank + n]
    cc = proj[..., dt_rank + n:]
    a_mat = -torch.exp(lp["A_log"]).to(xc.dtype)
    y, h_fin = selective_scan(xc.float(), dt.float(), a_mat.float(),
                              bc.float(), cc.float(), m.chunk)
    y = y.to(x.dtype) + lp["D"].to(x.dtype) * xc
    y = y * F.silu(z)
    conv_buf = xin[:, -(m.d_conv - 1):, :]
    out = pm.apply_linear(lp["out_proj"], y)
    return (out if split is None else split.sum(out)), h_fin, conv_buf


def mamba1_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                 device: DeviceLike = None) -> dict:
    m = cfg.ssm
    di = m.expand * cfg.d_model
    dev = resolve_device(device)
    return {"h": torch.zeros((cfg.n_layers, batch, di, m.d_state),
                             dtype=dtype, device=dev),
            "conv": torch.zeros((cfg.n_layers, batch, m.d_conv - 1, di),
                                dtype=dtype, device=dev)}


def mamba1_step(lp, x1, h, conv_buf, cfg: ModelConfig, split=None):
    """Decode: x1 (B,1,d); h (B,di,N); conv_buf (B,width-1,di) (under a
    tensor ``split`` this rank's channels). Returns (out (B,1,d), h,
    conv_buf)."""
    _, dt_rank, n = _dims(cfg)
    di = lp["A_log"].shape[0]
    f32 = torch.float32
    xz = pm.apply_linear(lp["in_proj"], x1)
    xin, z = xz[..., :di], xz[..., di:]
    conv_buf, xc = conv1d_step(lp["conv"], conv_buf, xin)
    xc = F.silu(xc)
    proj = pm.apply_linear(lp["x_proj"], xc)
    if split is not None:
        proj = split.sum(proj)
    dt = F.softplus(pm.apply_linear(lp["dt_proj"], proj[..., :dt_rank]))
    bc = proj[..., dt_rank:dt_rank + n]
    cc = proj[..., dt_rank + n:]
    a_mat = -torch.exp(lp["A_log"]).to(f32)
    da = torch.exp(dt[:, 0, :, None].to(f32) * a_mat)
    dbx = (dt[:, 0, :, None] * bc[:, 0, None, :]
           * xc[:, 0, :, None]).to(f32)
    h = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h, cc[:, 0].to(f32))
    y = y + lp["D"].to(f32) * xc[:, 0].to(f32)
    y = (y * F.silu(z[:, 0]).to(f32)).to(x1.dtype)
    out = pm.apply_linear(lp["out_proj"], y[:, None])
    return (out if split is None else split.sum(out)), h, conv_buf


# ---------------------------------------------------------------------------
# mamba2 (SSD) — zamba2
# ---------------------------------------------------------------------------


def init_mamba2(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    m = cfg.ssm
    di, _, n = _dims(cfg)
    nh = di // m.head_dim
    return {
        # separate projections, as the reference keeps them
        "z_proj": pm.linear(d, di, spec=("fsdp", "tp")),
        "x_proj": pm.linear(d, di, spec=("fsdp", "tp")),
        "bc_proj": pm.linear(d, 2 * n, spec=("fsdp", None)),
        "dt_proj": pm.linear(d, nh, spec=("fsdp", None)),
        "conv_x": conv1d_init(di, m.d_conv),
        "conv_bc": conv1d_init(2 * n, m.d_conv, tp=None),
        # log(linspace(1, 16, nh)), D = 1, dt_bias = 0: constants, no draw
        "A_log": pm.constant((nh,), np.log(
            np.linspace(1.0, 16.0, nh).astype(np.float32).astype(np.float64)),
            ("tp",)),
        "D": pm.Init((nh,), fill=1.0, spec=("tp",)),
        "dt_bias": pm.Init((nh,), spec=(None,)),
        "norm": pm.rmsnorm(di),
        "out_proj": pm.linear(di, d, spec=("tp", "fsdp")),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) with [i, j] = sum_{k=j+1..i} a_k (i >= j),
    -inf above the diagonal (``where``, never ``mask * inf``)."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -math.inf)


def ssd(x, dt, a_head, bmat, cmat, chunk: int):
    """Mamba2 SSD. x (B,S,H,P); dt (B,S,H); a_head (H,) negative;
    bmat/cmat (B,S,N). Returns y (B,S,H,P) and the final state (B,H,P,N).

    The reference's four-operand einsums are contracted pairwise so that
    no intermediate exceeds (b, c, h, l, l) elements: the (l x l) product
    ``C B^T`` is formed once and weighted by the decay kernel."""
    b, s, h, pdim = x.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))

    def ch(t):
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc = ch(x), ch(dt)
    bc, cc = ch(bmat), ch(cmat)
    xbar = xc * dtc[..., None]                           # (b,c,l,h,p)
    a_t = (dtc * a_head).transpose(-1, -2)               # (b,c,h,l) log decay
    acum = torch.cumsum(a_t, dim=-1)                     # (b,c,h,l)

    # intra-chunk (diagonal blocks): (C B^T) weighted by the decay kernel
    ldec = torch.exp(_segsum(a_t))                       # (b,c,h,l,s)
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)         # (b,c,l,s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", ldec * cb[:, :, None],
                          xbar)

    # per-chunk output states
    dstate = torch.exp(acum[..., -1:] - acum)            # (b,c,h,l)
    states = torch.einsum("bcln,bclhp->bchpn", bc,
                          xbar * dstate.transpose(-1, -2)[..., None])

    # inter-chunk recurrence
    cdecay = torch.exp(acum[..., -1])                    # (b,c,h)
    carry = torch.zeros((b, h, pdim, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * cdecay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                      # (b,c,h,p,n)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev) \
        * torch.exp(acum).transpose(-1, -2)[..., None]
    y = (y_diag + y_off).reshape(b, nc * chunk, h, pdim)
    return y[:, :s], carry


def mamba2_forward(lp, x, cfg: ModelConfig, shd: ShardCtx = NO_SHARD,
                   split=None):
    """One mamba2 block. x (B,S,d). Returns (out, final state (B,H,P,N)
    float32, conv_x buffer, conv_bc buffer); under a tensor ``split``
    (``inner_split``) the state and the conv_x buffer hold this rank's
    heads."""
    m = cfg.ssm
    d_inner, _, n = _dims(cfg)
    nh = lp["A_log"].shape[0]                  # this rank's heads
    di = nh * m.head_dim
    f32 = torch.float32
    xs = x if split is None else split.enter(x)
    z = pm.apply_linear(lp["z_proj"], xs)
    xraw = pm.apply_linear(lp["x_proj"], xs)
    bcraw = pm.apply_linear(lp["bc_proj"], x)
    dt = pm.apply_linear(lp["dt_proj"], xs)
    xin = F.silu(conv1d_apply(lp["conv_x"], xraw))
    bcin = F.silu(conv1d_apply(lp["conv_bc"], bcraw))
    if split is not None:
        bcin = split.enter(bcin)
    bmat, cmat = bcin[..., :n], bcin[..., n:]
    dt = F.softplus(dt + lp["dt_bias"].to(dt.dtype))
    a_head = -torch.exp(lp["A_log"]).to(f32)
    bsz, s, _ = x.shape
    xh = xin.reshape(bsz, s, nh, m.head_dim)
    y, h_fin = ssd(xh.to(f32), dt.to(f32), a_head, bmat.to(f32),
                   cmat.to(f32), m.chunk)
    y = y + lp["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = pm.apply_rmsnorm(lp["norm"], y * F.silu(z), cfg.norm_eps, split,
                         d_inner)
    w = m.d_conv - 1
    out = pm.apply_linear(lp["out_proj"], y)
    return ((out if split is None else split.sum(out)), h_fin,
            xraw[:, -w:, :], bcraw[:, -w:, :])


def mamba2_state(cfg: ModelConfig, n_layers: int, batch: int,
                 dtype=torch.float32, device: DeviceLike = None) -> dict:
    m = cfg.ssm
    di = m.expand * cfg.d_model
    nh = di // m.head_dim
    dev = resolve_device(device)
    return {"h": torch.zeros((n_layers, batch, nh, m.head_dim, m.d_state),
                             dtype=dtype, device=dev),
            "conv_x": torch.zeros((n_layers, batch, m.d_conv - 1, di),
                                  dtype=dtype, device=dev),
            "conv_bc": torch.zeros((n_layers, batch, m.d_conv - 1,
                                    2 * m.d_state), dtype=dtype, device=dev)}


def mamba2_step(lp, x1, h, conv_x_buf, conv_bc_buf, cfg: ModelConfig,
                split=None):
    """Decode: x1 (B,1,d); h (B,H,P,N); conv bufs (B,w-1,*) (under a tensor
    ``split`` ``h`` and the conv_x buffer hold this rank's heads). Returns
    (out (B,1,d), h, conv_x_buf, conv_bc_buf)."""
    m = cfg.ssm
    d_inner, _, n = _dims(cfg)
    nh = lp["A_log"].shape[0]
    di = nh * m.head_dim
    f32 = torch.float32
    z = pm.apply_linear(lp["z_proj"], x1)
    xin = pm.apply_linear(lp["x_proj"], x1)
    bcin = pm.apply_linear(lp["bc_proj"], x1)
    dt = pm.apply_linear(lp["dt_proj"], x1)
    conv_x_buf, xin = conv1d_step(lp["conv_x"], conv_x_buf, xin)
    conv_bc_buf, bcin = conv1d_step(lp["conv_bc"], conv_bc_buf, bcin)
    xin, bcin = F.silu(xin), F.silu(bcin)
    bmat, cmat = bcin[..., :n], bcin[..., n:]
    dt = F.softplus(dt + lp["dt_bias"].to(dt.dtype))[:, 0]   # (B,H)
    a_head = -torch.exp(lp["A_log"]).to(f32)
    xh = xin[:, 0].reshape(-1, nh, m.head_dim).to(f32)
    dec = torch.exp(dt.to(f32) * a_head)                 # (B,H)
    xbar = xh * dt.to(f32)[..., None]
    h = (h * dec[..., None, None]
         + torch.einsum("bn,bhp->bhpn", bmat[:, 0].to(f32), xbar))
    y = torch.einsum("bhpn,bn->bhp", h, cmat[:, 0].to(f32))
    y = y + lp["D"].to(f32)[None, :, None] * xh
    y = y.reshape(x1.shape[0], di).to(x1.dtype)
    y = pm.apply_rmsnorm(lp["norm"], y * F.silu(z[:, 0]), cfg.norm_eps,
                         split, d_inner)
    out = pm.apply_linear(lp["out_proj"], y[:, None])
    return ((out if split is None else split.sum(out)), h, conv_x_buf,
            conv_bc_buf)
