"""Plain PyTorch oracles for the kernels (the allclose targets)."""
from __future__ import annotations

import torch


def drop_masked_slots(vals: torch.Tensor, col_idx: torch.Tensor,
                      nbr_mask: torch.Tensor | None):
    """Select away the ELL slots under a False ``nbr_mask`` bit, as the
    SpMV kernel skips them: their tiles become 0 and their column blocks 0
    (so a stale index gathers in range). Returns ``(vals, col_idx, keep)``
    with ``keep`` the mask broadcast over a slot's (bs, ·) block, for
    zeroing the gathered segments too; ``keep`` is None without a mask.
    Selection, not multiplication by the mask: NaN x 0 is NaN."""
    if nbr_mask is None:
        return vals, col_idx, None
    keep = nbr_mask[..., None, None]
    return (torch.where(keep, vals, 0.0), torch.where(nbr_mask, col_idx, 0),
            keep)


def bsr_spmv_ref(vals: torch.Tensor, col_idx: torch.Tensor,
                 x: torch.Tensor,
                 nbr_mask: torch.Tensor | None = None) -> torch.Tensor:
    """vals (n_rb, nbr, bs, bs); col_idx (n_rb, nbr); x (n_cb*bs, f);
    nbr_mask (n_rb, nbr) bool, or None when every slot is kept."""
    n_rb, nbr, bs, _ = vals.shape
    xb = x.reshape(-1, bs, x.shape[-1])          # (n_cb, bs, f)
    vals, col_idx, keep = drop_masked_slots(vals, col_idx, nbr_mask)
    seg = xb[col_idx.long()]                     # (n_rb, nbr, bs, f)
    if keep is not None:
        seg = torch.where(keep, seg, 0.0)
    y = torch.einsum("rnij,rnjf->rif", vals, seg)
    return y.reshape(n_rb * bs, -1)


def gamma_pairs_ref(coords: torch.Tensor, sigma: float) -> torch.Tensor:
    """Literal dense (n, n) pair sum — small inputs only."""
    c = coords.to(torch.float32)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2 / (sigma * sigma)).sum()


def tsne_force_ref(p_vals: torch.Tensor, col_idx: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Oracle for kernels.tsne_force (same contract, unchunked — small
    inputs only): p_vals (n_rb, nbr, bs, bs); col_idx (n_rb, nbr);
    y (n_cb*bs, d). Returns F (n_rb*bs, d)."""
    n_rb, nbr, bs, _ = p_vals.shape
    d = y.shape[-1]
    yb = y.reshape(-1, bs, d)
    ys = yb[col_idx.long()]                           # (n_rb, nbr, bs, d)
    yt = yb[:n_rb]
    diff = yt[:, None, :, None, :] - ys[:, :, None, :, :]
    q = 1.0 / (1.0 + (diff * diff).sum(-1))
    w = p_vals * q
    f = torch.einsum("rnts,rntsd->rtd", w, diff)
    return f.reshape(n_rb * bs, d)


def block_attention_ref(q: torch.Tensor, k_sorted: torch.Tensor,
                        v_sorted: torch.Tensor, kpos: torch.Tensor,
                        qpos: torch.Tensor, idx: torch.Tensor, *, bq: int,
                        bk: int, causal: bool = True) -> torch.Tensor:
    """Single-slice oracle of kernels.block_attention: q (S, dh);
    k/v_sorted (S_k, dh|dv); kpos (S_k,); qpos (S,); idx (S/bq, n_sel).
    One flat softmax per query tile over its gathered key tiles."""
    s, dh = q.shape
    dv = v_sorted.shape[-1]
    nqb = s // bq
    scale = 1.0 / (dh ** 0.5)
    kb = k_sorted.reshape(-1, bk, dh)
    vb = v_sorted.reshape(-1, bk, dv)
    pb = kpos.reshape(-1, bk)
    out = []
    for i in range(nqb):
        qi = q[i * bq:(i + 1) * bq].float()
        sel = idx[i].long()
        ks = kb[sel].reshape(-1, dh).float()
        vs = vb[sel].reshape(-1, dv).float()
        ps = pb[sel].reshape(-1)
        logit = qi @ ks.T * scale
        if causal:
            ok = ps[None, :] <= qpos[i * bq:(i + 1) * bq][:, None]
            logit = torch.where(ok, logit, -1e30)
        w = torch.softmax(logit, dim=-1)
        out.append((w @ vs).to(q.dtype))
    return torch.cat(out, dim=0)
