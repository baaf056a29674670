"""Plain PyTorch versions of the port's kernels (the oracles)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (BH, S, D) — dense softmax attention in fp32."""
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
    k, v (B, S, KV, D) -> (B, S, H, D), GQA by repeating kv heads and
    folding heads into the batch as ``repro.kernels.ops`` does."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if h != kvh:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * h, -1, d)
    vf = v.transpose(1, 2).reshape(b * h, -1, d)
    out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, s, d).transpose(1, 2)


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
