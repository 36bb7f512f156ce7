"""Plain reference of an MLA decoder (MiniCPM3) trained through ClusterKV
attention, in float32 PyTorch: forward, loss, gradients by autograd,
AdamW. It imports nothing of the program and takes nothing the program
made: the weights are drawn again from the seed (``harness/weights.py``),
the batches made again from it (``harness/gen.py``), and ClusterKV's key
ordering and tile selection are worked out again from the reference's own
keys.

The model, as the configuration file states it:

* ``h = embed[tokens]``; per layer (checkpointed, so that the activations
  of one layer at a time are kept), pre-norm residual blocks:
  ``x += wo(attn(...))``, ``x += wd(silu(wg h) * wu h)``; RMSNorm with a
  scale, eps ``rms_norm_eps``; the final norm, then the untied head; the
  mean cross-entropy of the next tokens.
* MLA: ``q = q_b(norm(q_a h))`` split into a no-position part (dn) and a
  rotary part (dr); the latent ``kv_a h`` split into ``c`` (normed, rank
  kr) and a shared rotary key (dr); ``kv_b c`` gives each head's key part
  (dn) and value (dv). Rotary embedding on the last axis's two halves,
  angle ``pos * theta^(-i / half)``.
* ClusterKV attention (causal): each head's keys are centred, projected on
  their top-``embed_dim`` principal axes (four sweeps of subspace
  iteration from the first coordinate axes, QR after each), quantized to
  ``morton_bits`` bits per axis in the keys' own box, and stably sorted by
  their Morton codes. Keys are cut into tiles of ``block_k`` in that
  order; each query tile of ``block_q`` (in time order) scores every key
  tile by the dot product of the mean query and the mean key, drops tiles
  whose every key lies after the whole query tile, adds 1e4 to tiles
  holding a key within ``local_window_blocks * block_k`` positions before
  the query tile's first, and keeps the ``blocks_per_query`` best (ties to
  the lower tile). Each query attends, with softmax at scale
  ``1/sqrt(dn + dr)``, to the kept tiles' keys at or before its position;
  a masked logit is -1e30, so a row with no visible key averages its
  tiles' values (the program's convention).
* AdamW: gradients averaged over the microbatches, clipped to global norm
  ``clip``, moments ``b1``/``b2``, ``eps``, decoupled weight decay on
  every leaf, learning rate a linear warm-up over ``warmup`` steps then a
  cosine to ``min_lr_frac`` of the peak at ``total_steps``, evaluated at
  the step count after the increment.

``low="int8"`` is the control (``"fp8"`` the other format one step below
bf16): every weight product's two operands in int8 (float8 e4m3) with a
per-tensor scale (amax to the format's largest value) and its backward's
incoming gradient in int8 (e5m2); attention's two products take rounded
operands in the forward pass, the gradient straight through.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def _round_low(t: torch.Tensor, low: str, grad: bool = False
               ) -> torch.Tensor:
    """``t`` rounded to the control's format with a per-tensor scale (its
    amax to the format's largest value), back in float32: ``fp8`` is e4m3
    (e5m2 for a gradient), ``int8`` symmetric int8."""
    if low == "int8":
        s = t.abs().amax().clamp_min(1e-30) / 127.0
        return torch.round(t / s).clamp_(-127, 127) * s
    dtype = torch.float8_e5m2 if grad else torch.float8_e4m3fn
    s = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / s).to(dtype).float() * s


def _q(t: torch.Tensor, low: str) -> torch.Tensor:
    """Rounded in the forward pass, the gradient straight through."""
    return t + (_round_low(t.detach(), low) - t).detach()


class _MatmulLow(torch.autograd.Function):
    """``a @ b`` with both operands rounded and, in the backward pass, the
    incoming gradient rounded (the usual low-precision training recipe)."""

    @staticmethod
    def forward(ctx, a, b, low):
        qa, qb = _round_low(a, low), _round_low(b, low)
        ctx.save_for_backward(qa, qb)
        ctx.low = low
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_low(g, ctx.low, grad=True)
        ga = qg @ qb.mT
        gb = qa.reshape(-1, qa.shape[-1]).mT @ qg.reshape(-1, qg.shape[-1])
        return ga, gb, None


class Model:
    def __init__(self, m: Dict[str, Any], low: Optional[str] = None):
        self.m = m
        self.low = low
        self.ck = m["clusterkv"]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.low:
            return _MatmulLow.apply(a, b, self.low)
        return a @ b

    def rms(self, x, w):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["rms_norm_eps"]) * w

    def rope(self, x, pos):
        half = x.shape[-1] // 2
        freqs = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * freqs
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    # -- ClusterKV ---------------------------------------------------------

    def key_order(self, k: torch.Tensor) -> torch.Tensor:
        """(B, H, S, dh) keys -> (B, H, S) cluster order."""
        d, bits = self.ck["embed_dim"], self.ck["morton_bits"]
        xc = k - k.mean(dim=-2, keepdim=True)
        q = torch.eye(k.shape[-1], d, dtype=k.dtype, device=k.device)
        q = q.expand(tuple(k.shape[:-2]) + (k.shape[-1], d))
        for _ in range(self.ck["pca_iters"]):
            q, _ = torch.linalg.qr(xc.mT @ (xc @ q))
        y = xc @ q
        lo = y.amin(dim=-2, keepdim=True)
        hi = y.amax(dim=-2, keepdim=True)
        top = 2 ** bits - 1
        cells = torch.clamp((y - lo) / torch.clamp_min(hi - lo, 1e-30) * top,
                            0, top).to(torch.int64)
        code = torch.zeros(cells.shape[:-1], dtype=torch.int64,
                           device=k.device)
        for bit in range(bits):
            for axis in range(d):
                code |= ((cells[..., axis] >> bit) & 1) << (d * bit + axis)
        return torch.argsort(code, dim=-1, stable=True)

    def attention(self, q, k, v, pos):
        """q, k (B, H, S, dqk), v (B, H, S, dv), pos (S,) -> (B, H, S, dv)."""
        b, h, s, dqk = q.shape
        dv = v.shape[-1]
        bq, bk = min(self.ck["block_q"], s), min(self.ck["block_k"], s)
        nqb, nkb = s // bq, s // bk
        n_sel = min(self.ck["blocks_per_query"], nkb)
        with torch.no_grad():
            order = self.key_order(k.detach())
            k_s = torch.gather(k.detach(), 2, order[..., None].expand(
                b, h, s, dqk))
            kpos = pos[order]                                # (B, H, S)
            kt = kpos.reshape(b, h, nkb, bk)
            kmin, kmax = kt.amin(-1), kt.amax(-1)
            qt = pos.reshape(nqb, bq)
            qmin, qmax = qt.amin(-1), qt.amax(-1)
            qc = q.detach().reshape(b, h, nqb, bq, dqk).mean(3)
            kc = k_s.reshape(b, h, nkb, bk, dqk).mean(3)
            score = torch.einsum("bhqd,bhkd->bhqk", qc, kc)
            late = kmin[:, :, None, :] > qmax[None, None, :, None]
            score = torch.where(late, NEG, score)
            near = (kmax[:, :, None, :] >= (
                qmin[None, None, :, None]
                - self.ck["local_window_blocks"] * bk)) & ~late
            score = torch.where(near, score + 1e4, score)
            sel = torch.sort(score, dim=-1, descending=True,
                             stable=True).indices[..., :n_sel]
            # key slots of the kept tiles, in tile order (B, H, nqb, n_sel*bk)
            slots = (order.reshape(b, h, nkb, bk)[
                torch.arange(b, device=q.device)[:, None, None, None],
                torch.arange(h, device=q.device)[None, :, None, None],
                sel]).reshape(b, h, nqb, n_sel * bk)
            vis = pos[slots][:, :, :, None, :] <= qt[None, None, :, :, None]
        flat = slots.reshape(b, h, nqb * n_sel * bk)
        ksel = torch.gather(k, 2, flat[..., None].expand(-1, -1, -1, dqk))
        vsel = torch.gather(v, 2, flat[..., None].expand(-1, -1, -1, dv))
        ksel = ksel.reshape(b, h, nqb, n_sel * bk, dqk)
        vsel = vsel.reshape(b, h, nqb, n_sel * bk, dv)
        qb = q.reshape(b, h, nqb, bq, dqk)
        if self.low:
            qb, ksel = _q(qb, self.low), _q(ksel, self.low)
        logit = torch.einsum("bhqtd,bhqsd->bhqts", qb, ksel) / math.sqrt(dqk)
        p = torch.softmax(torch.where(vis, logit, NEG), dim=-1)
        if self.low:
            p, vsel = _q(p, self.low), _q(vsel, self.low)
        out = torch.einsum("bhqts,bhqsd->bhqtd", p, vsel)
        return out.reshape(b, h, s, dv)

    # -- the model -----------------------------------------------------------

    def layer(self, lp: Dict[str, torch.Tensor], x, pos):
        m = self.m
        b, s, _ = x.shape
        h = m["num_attention_heads"]
        dn, dr, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
        kr = m["kv_lora_rank"]
        hn = self.rms(x, lp["ln1"])
        qlat = self.rms(self.mm(hn, lp["q_a"]), lp["q_ln"])
        q = self.mm(qlat, lp["q_b"]).reshape(b, s, h, dn + dr).transpose(1, 2)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], dim=-1)
        kv = self.mm(hn, lp["kv_a"])
        c = self.rms(kv[..., :kr], lp["kv_ln"])
        krope = self.rope(kv[..., kr:], pos)                 # (B, S, dr)
        kx = self.mm(c, lp["kv_b"]).reshape(b, s, h, dn + dv).transpose(1, 2)
        k = torch.cat([kx[..., :dn],
                       krope[:, None].expand(b, h, s, dr)], dim=-1)
        o = self.attention(q, k, kx[..., dn:], pos)
        x = x + self.mm(o.transpose(1, 2).reshape(b, s, h * dv), lp["wo"])
        hn = self.rms(x, lp["ln2"])
        f = torch.nn.functional.silu(self.mm(hn, lp["wg"])) \
            * self.mm(hn, lp["wu"])
        return x + self.mm(f, lp["wd"])

    def loss(self, p: Dict[Tuple[str, ...], torch.Tensor], tokens, labels):
        m = self.m
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = p[("embed", "table")][tokens.long()]
        stacked = {path[1:]: t.unbind(0) for path, t in p.items()
                   if path[0] == "layers"}
        for i in range(m["num_hidden_layers"]):
            lp = {path[-2] if path[-1] in ("w", "scale") else path[-1]:
                  ts[i] for path, ts in stacked.items()}
            x = checkpoint(self.layer, lp, x, pos, use_reentrant=False)
        hf = self.rms(x, p[("ln_f", "scale")]).reshape(-1, x.shape[-1])
        lf = labels.reshape(-1).long()
        chunk = m["training"]["loss_chunk"]
        chunk = chunk if hf.shape[0] % chunk == 0 else hf.shape[0]

        def ce(hc, w, lc):
            logits = self.mm(hc, w)
            return (torch.logsumexp(logits, -1)
                    - logits.gather(-1, lc[:, None])[:, 0]).sum()
        total = sum(checkpoint(ce, hf[i:i + chunk], p[("head", "w")],
                               lf[i:i + chunk], use_reentrant=False)
                    for i in range(0, hf.shape[0], chunk))
        return total / hf.shape[0]


def lr_at(t: int, tr: Dict[str, Any]) -> float:
    base, warm, total = tr["lr"], tr["warmup"], tr["total_steps"]
    if t < warm:
        return base * min((t + 1) / max(warm, 1), 1.0)
    frac = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (tr["min_lr_frac"] + (1 - tr["min_lr_frac"]) * 0.5
                   * (1 + math.cos(math.pi * frac)))


def train(m: Dict[str, Any], params: Dict[Tuple[str, ...], torch.Tensor],
          batches: List[Dict[str, torch.Tensor]], microbatches: int,
          low: Optional[str] = None) -> Dict[str, Any]:
    """Runs ``len(batches)`` AdamW steps on ``params`` (float32 leaves by
    path, updated in place). Returns the losses, each leaf's norm of the
    first step's clipped gradient, and each leaf's norm of the change over
    all the steps."""
    model = Model(m, low)
    tr = m["training"]
    paths = list(params)
    start = {k: v.detach().clone() for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for t, batch in enumerate(batches, start=1):
        acc = {k: torch.zeros_like(v) for k, v in params.items()}
        loss_sum = 0.0
        n = batch["tokens"].shape[0] // microbatches
        for j in range(microbatches):
            live = [params[k].detach().requires_grad_(True) for k in paths]
            lp = dict(zip(paths, live))
            with torch.enable_grad():
                loss = model.loss(lp, batch["tokens"][j * n:(j + 1) * n],
                                  batch["labels"][j * n:(j + 1) * n])
                grads = torch.autograd.grad(loss, live)
            loss_sum += float(loss.detach())
            for k, g in zip(paths, grads):
                acc[k].add_(g)
            del grads, live, lp, loss
        with torch.no_grad():
            for k in paths:
                acc[k].div_(microbatches)
            norm = math.sqrt(sum(float(g.double().square().sum())
                                 for g in acc.values()))
            scale = min(1.0, tr["clip"] / max(norm, 1e-9))
            for k in paths:
                acc[k].mul_(scale)
            if t == 1:
                grad1 = {k: float(acc[k].double().norm()) for k in paths}
            lr = lr_at(t, tr)
            bc1, bc2 = 1 - tr["b1"] ** t, 1 - tr["b2"] ** t
            for k in paths:
                g, p = acc[k], params[k]
                mom[k].mul_(tr["b1"]).add_(g, alpha=1 - tr["b1"])
                vel[k].mul_(tr["b2"]).addcmul_(g, g, value=1 - tr["b2"])
                u = (mom[k] / bc1) / ((vel[k] / bc2).sqrt() + tr["eps"])
                u.add_(p, alpha=tr["weight_decay"])
                p.sub_(u, alpha=lr)
        del acc
        losses.append(loss_sum / microbatches)
    change = {k: float((params[k] - start[k]).double().norm())
              for k in paths}
    return {"losses": losses, "grad1": grad1, "change": change}
