"""Plain PyTorch versions of the port's kernels (the oracles)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k: (BH, S, D); v: (BH, S, Dv) — dense softmax attention in fp32,
    scaled by 1 / sqrt(D)."""
    bh, s, d = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """The flash kernel's function in the model layout: q (B, S, H, D),
    k (B, S, KV, D), v (B, S, KV, Dv) -> (B, S, H, Dv), GQA by repeating kv
    heads and folding heads into the batch as ``repro.kernels.ops`` does."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if h != kvh:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * h, -1, d)
    vf = v.transpose(1, 2).reshape(b * h, -1, dv)
    out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, s, dv).transpose(1, 2)


def _grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int):
    """fp32 views for GQA: q (B, KV, G, S, D), k and v (B, KV, Sk, D), the
    scaled scores (B, KV, G, S, Sk) and the (S, Sk) mask of visible pairs."""
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)
    vg = v.float().permute(0, 2, 1, 3)
    scores = torch.einsum("bkgqd,bkjd->bkgqj", qg, kg) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return qg, kg, vg, scores, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0) -> torch.Tensor:
    """Each row's logsumexp of the scaled visible scores, as the flash
    kernel writes it for its backward: (B, H, S) fp32, -inf for a row
    with no visible key."""
    b, s, h, _ = q.shape
    *_, scores, mask = _grouped(q, k, v, causal, window)
    lse = torch.logsumexp(scores.masked_fill(~mask, -math.inf), dim=-1)   # (B, KV, G, S)
    return lse.reshape(b, h, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward kernel's formulas in fp32 (not autograd): P from
    the forward's lse, Delta = rowsum(dO * O), dS = P * (dO V^T - Delta),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO, with dK and dV
    summed over each kv head's q heads.  q (B, S, H, D); o, do (B, S, H,
    Dv); k (B, Sk, KV, D), v (B, Sk, KV, Dv); lse (B, H, S) -> (dq, dk, dv)
    in the inputs' dtypes."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    qg, kg, vg, scores, mask = _grouped(q, k, v, causal, window)
    dog = do.float().reshape(b, s, kvh, h // kvh, dv).permute(0, 2, 3, 1, 4)
    og = o.float().reshape(b, s, kvh, h // kvh, dv).permute(0, 2, 3, 1, 4)
    lse_g = lse.float().reshape(b, kvh, h // kvh, s)
    p = torch.where(mask, torch.exp(scores - lse_g[..., None]), 0.0)
    delta = (dog * og).sum(-1)                                           # (B, KV, G, S)
    ds = p * (torch.einsum("bkgqd,bkjd->bkgqj", dog, vg) - delta[..., None])
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bkgqj,bkjd->bkgqd", ds, kg) * scale
    dk = torch.einsum("bkgqj,bkgqd->bkjd", ds, qg) * scale
    dv = torch.einsum("bkgqj,bkgqd->bkjd", p, dog)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Naive per-step SSD recurrence (fp32).

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N)  [G=1].
    Returns (y (B, L, H, P), final_state (B, H, P, N)) in x's dtype.
    """
    bb, l, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * a[None, :].float())             # (B,H)
        upd = torch.einsum("bhp,bn,bh->bhpn", xf[:, t], bf[:, t], dtf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)
