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


def flash_attention_staged_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               widths: tuple[int, int]) -> torch.Tensor:
    """The staged route's function (kernels/flash_attention.py:route, kind
    "stage") in fp32, differentiable by autograd: q, k and v zero-padded to
    the pitch (each head dim rounded up to a multiple of 8) and, as TMA
    zero-fills the tensor maps' last box, on to the bucket's ``widths``;
    softmax attention there, scaled by 1 / sqrt(q's real head dim); a row
    with no visible key gives zeros, as the wgmma kernels write; o cut back
    to v's real head dim.  q (B, S, H, D), k (B, Sk, KV, D), v (B, Sk, KV,
    Dv) -> o (B, S, H, Dv) in q's dtype."""
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    wk, wv = widths

    def staged(t: torch.Tensor, width: int) -> torch.Tensor:
        pitched = torch.nn.functional.pad(t.float(), (0, -(-t.shape[-1] // 8) * 8 - t.shape[-1]))
        return torch.nn.functional.pad(pitched, (0, width - pitched.shape[-1]))

    qg = staged(q, wk).reshape(b, s, kvh, h // kvh, wk).permute(0, 2, 3, 1, 4)
    kg, vg = staged(k, wk).permute(0, 2, 1, 3), staged(v, wv).permute(0, 2, 1, 3)
    scores = torch.einsum("bkgqd,bkjd->bkgqj", qg, kg) / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    # masked to a finite floor, so that a row with no visible key stays
    # finite through autograd before it is zeroed
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1) * mask.any(-1)[:, None]
    o = torch.einsum("bkgqj,bkjd->bkgqd", p, vg)                    # (B, KV, G, S, wv)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, wv)[..., :dv].to(q.dtype)


def flash_attention_fwd_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                  causal: bool = True, window: int = 0, rows: int,
                                  stream_rows: int, widths: tuple[int, int]
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 forward kernel's decomposition (csrc/flash_attention_fwd_f32.cu)
    in fp32: q, k and v zero-padded to the bucket's ``widths`` (and k, v to
    whole kv tiles); blocks of ``rows`` q rows over the kv tiles of
    ``stream_rows`` that hold a key some row of the block sees; an online
    softmax in base 2 (scores masked to -1e30, the running max m, alpha =
    exp2(m_old - m), P = exp2(s - m), l = l alpha + rowsum(P)), O = O alpha
    + P V; o = O / max(l, 1e-30) and lse = (m + log2 l) / log2(e), -inf
    where m stayed -1e30.  A row with no visible key weighs every slot of
    its block's tiles 1 (zero rows past Sk); a block with no tile writes
    zeros.  q (B, S, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv) -> (o (B, S,
    H, Dv) in q's dtype, lse (B, H, S) fp32)."""
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    wk, wv = widths
    pad_k = -(-sk // stream_rows) * stream_rows - sk
    kv_of = torch.arange(h, device=q.device) // (h // kvh)
    qf = torch.nn.functional.pad(q.float(), (0, wk - d))
    kf = torch.nn.functional.pad(k.float(), (0, wk - d, 0, 0, 0, pad_k))[:, :, kv_of]
    vf = torch.nn.functional.pad(v.float(), (0, wv - dv, 0, 0, 0, pad_k))[:, :, kv_of]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    neg = -1e30
    o = torch.zeros((b, s, h, wv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, rows):
        qn = min(rows, s - q0)
        hi = min(sk, q0 + rows) if causal else sk
        lo = max(0, q0 - window + 1) if window else 0
        m = torch.full((b, h, qn), neg, device=q.device)
        l = torch.zeros((b, h, qn), device=q.device)
        acc = torch.zeros((b, h, qn, wv), device=q.device)
        for t in range(lo // stream_rows, -(-hi // stream_rows) if hi > lo else 0):
            k0 = t * stream_rows
            sc = torch.einsum("bqhd,bnhd->bhqn", qf[:, q0:q0 + qn],
                              kf[:, k0:k0 + stream_rows]) * scale_log2
            qp = torch.arange(q0, q0 + qn, device=q.device)[:, None]
            kp = torch.arange(k0, k0 + stream_rows, device=q.device)[None, :]
            vis = kp < sk
            if causal:
                vis = vis & (kp <= qp)
            if window:
                vis = vis & (kp > qp - window)
            sc = torch.where(vis, sc, neg)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqn,bnhd->bhqd", p,
                                                        vf[:, k0:k0 + stream_rows])
            m = m_new
        o[:, q0:q0 + qn] = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
        lse[:, :, q0:q0 + qn] = torch.where(m == neg, -math.inf,
                                            (m + torch.log2(l)) / math.log2(math.e))
    return o[..., :dv].to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0, shares: int = 1
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward kernel's formulas in fp32 (not autograd): P from
    the forward's lse, Delta = rowsum(dO * O), dS = P * (dO V^T - Delta),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO, with dK and dV
    summed over each kv head's q heads.  q (B, S, H, D); o, do (B, S, H,
    Dv); k (B, Sk, KV, D), v (B, Sk, KV, Dv); lse (B, H, S) -> (dq, dk, dv)
    in the inputs' dtypes.  ``shares`` > 1 sums dK and dV as the
    two-warpgroup dK/dV kernel does when it splits a group of G q heads
    into head shares: heads [j G / shares, (j + 1) G / shares) summed into
    share j's fp32 partial, the partials added in share order, dK scaled
    after."""
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
    group = h // kvh
    bounds = [j * group // shares for j in range(shares + 1)]
    dk = dv = None
    for lo, hi in zip(bounds, bounds[1:]):   # share by share, in order
        dk_j = torch.einsum("bkgqj,bkgqd->bkjd", ds[:, :, lo:hi], qg[:, :, lo:hi])
        dv_j = torch.einsum("bkgqj,bkgqd->bkjd", p[:, :, lo:hi], dog[:, :, lo:hi])
        dk, dv = (dk_j, dv_j) if dk is None else (dk + dk_j, dv + dv_j)
    dk = dk * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def flash_attention_bwd_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True, window: int = 0, rows: int,
                                  stream_rows: int, widths: tuple[int, int], shares: int = 1
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fp32 backward kernels' decomposition (csrc/flash_attention_bwd_f32.cu)
    in fp32: q, k, dO and v zero-padded to the bucket's ``widths``; the dQ
    kernel's blocks of ``rows`` q rows over the kv tiles of
    ``stream_rows`` that the masks leave visible, scores in base 2 from
    lse * log2(e), Delta = rowsum(dO * O); the dK/dV kernel's blocks
    of ``rows`` kv rows over their q tiles of ``stream_rows``, each kv head's
    group of q heads cut into ``shares`` (heads [j G / shares, (j + 1) G /
    shares)), each share summed over its heads and tiles in order into fp32
    partials that are added in share order, dK scaled after.  Shapes and
    outputs as :func:`flash_attention_bwd_ref`'s."""
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // kvh
    wk, wv = widths
    qf, kf = (torch.nn.functional.pad(t.float(), (0, wk - d)) for t in (q, k))
    dof, vf = (torch.nn.functional.pad(t.float(), (0, wv - dv)) for t in (do, v))
    scale = 1.0 / math.sqrt(d)
    scale_log2 = math.log2(math.e) * scale
    lse2 = lse.float() * math.log2(math.e)                             # (B, H, S)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)           # (B, H, S)

    def mask(q0: int, qn: int, k0: int, kn: int) -> torch.Tensor:
        qp = torch.arange(q0, q0 + qn, device=q.device)[:, None]
        kp = torch.arange(k0, k0 + kn, device=q.device)[None, :]
        m = (qp < s) & (kp < sk)
        if causal:
            m &= kp <= qp
        if window:
            m &= kp > qp - window
        return m

    def tiles(lo: int, hi: int, limit: int):   # the stream's tiles over [lo, hi)
        for t in range(lo // stream_rows, -(-hi // stream_rows) if hi > lo else 0):
            yield t * stream_rows, min(stream_rows, limit - t * stream_rows)

    kv_of = torch.arange(h, device=q.device) // group
    dq = torch.zeros_like(qf)
    for q0 in range(0, s, rows):
        qn = min(rows, s - q0)
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(sk, q0 + rows) if causal else sk
        for k0, kn in tiles(lo, hi, sk):
            kt, vt = kf[:, k0:k0 + kn, kv_of], vf[:, k0:k0 + kn, kv_of]    # (B, kn, H, W)
            sc = torch.einsum("bqhd,bnhd->bhqn", qf[:, q0:q0 + qn], kt)
            dp = torch.einsum("bqhd,bnhd->bhqn", dof[:, q0:q0 + qn], vt)
            m = mask(q0, qn, k0, kn)
            p = torch.where(m, torch.exp2(sc * scale_log2 - lse2[:, :, q0:q0 + qn, None]), 0.0)
            ds = torch.where(m, p * (dp - delta[:, :, q0:q0 + qn, None]), 0.0)
            dq[:, q0:q0 + qn] += torch.einsum("bhqn,bnhd->bqhd", ds, kt)
    bounds = [j * group // shares for j in range(shares + 1)]
    dk = dv_ = None
    for lo_h, hi_h in zip(bounds, bounds[1:]):   # share by share
        pk, pv = torch.zeros_like(kf), torch.zeros_like(vf)
        for k0 in range(0, sk, rows):
            kn = min(rows, sk - k0)
            lo = k0 if causal else 0
            hi = min(s, k0 + rows - 1 + window) if window else s
            for hh in range(lo_h, hi_h):   # the share's heads of every kv head
                heads = torch.arange(kvh, device=q.device) * group + hh
                for q0, qn in tiles(lo, hi, s):
                    qt, dot = qf[:, q0:q0 + qn, heads], dof[:, q0:q0 + qn, heads]
                    st = torch.einsum("bnkd,bqkd->bknq", kf[:, k0:k0 + kn], qt)
                    dpt = torch.einsum("bnkd,bqkd->bknq", vf[:, k0:k0 + kn], dot)
                    m = mask(q0, qn, k0, kn).T
                    l2 = lse2[:, heads, q0:q0 + qn][:, :, None]
                    pt = torch.where(m, torch.exp2(st * scale_log2 - l2), 0.0)
                    dst = torch.where(m, pt * (dpt - delta[:, heads, q0:q0 + qn][:, :, None]),
                                      0.0)
                    pv[:, k0:k0 + kn] += torch.einsum("bknq,bqkd->bnkd", pt, dot)
                    pk[:, k0:k0 + kn] += torch.einsum("bknq,bqkd->bnkd", dst, qt)
        dk, dv_ = (pk, pv) if dk is None else (dk + pk, dv_ + pv)
    return ((dq[..., :d] * scale).to(q.dtype), (dk[..., :d] * scale).to(k.dtype),
            dv_[..., :dv].to(v.dtype))


def ssd_groups(b: torch.Tensor, c: torch.Tensor, h: int
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """b and c as (B, L, G, N) with their group count G, which must divide
    the H heads: head h reads group h // (H / G).  (B, L, N) is G = 1."""
    if b.dim() == 3:
        b, c = b[:, :, None], c[:, :, None]
    g = b.shape[2]
    if g == 0 or h % g or c.shape != b.shape:
        raise ValueError(f"ssd_scan: b {tuple(b.shape)} and c {tuple(c.shape)}: the group "
                         f"count must divide the {h} heads and b and c must match")
    return b, c, g


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, initial_state: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Naive per-step SSD recurrence (fp32).

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) or (B, L,
    N) (G = 1), G dividing H; ``initial_state`` (B, H, P, N), held in fp32
    (None: zero).  Returns (y (B, L, H, P), final_state (B, H, P, N)) in
    x's dtype.
    """
    bb, l, h, p = x.shape
    b, c, g = ssd_groups(b, c, h)
    r, n = h // g, b.shape[-1]
    xf = x.float().reshape(bb, l, g, r, p)
    dtf = dt.float().reshape(bb, l, g, r)
    af = a.float().reshape(g, r)
    bf, cf = b.float(), c.float()
    state = (torch.zeros((bb, g, r, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float().reshape(bb, g, r, p, n))
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * af[None])                       # (B,G,R)
        upd = torch.einsum("bgrp,bgn,bgr->bgrpn", xf[:, t], bf[:, t], dtf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bgrpn,bgn->bgrp", state, cf[:, t]))
    y = torch.stack(ys, dim=1).reshape(bb, l, h, p)
    return y.to(x.dtype), state.reshape(bb, h, p, n).to(x.dtype)


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor | None = None, *,
                chunk: int = 64, initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor | None, ...]:
    """The SSD backward kernel's formulas in fp32 (not autograd), chunk by
    chunk as ``csrc/ssd_scan_bwd.cu`` states them: the state entering each
    chunk from a forward pass, then dS carried back over the chunks, and per
    chunk, with W_ij = (C_i . B_j) e^{cs_i - cs_j} and dY_ij = dy_i . u_j (u
    = dt x) on j <= i (masked before the exp): du = W^T dy + e^{cs_last -
    cs_j} dS B_j, dC = (e^{cs_i - cs_j} dY) B + e^{cs_i} S^T dy, dB =
    (e^{cs_i - cs_j} dY)^T C + e^{cs_last - cs_j} dS^T u, and the gradient
    of the in-chunk cumsums cs, summed back into dt and a.  dB and dC are
    summed over each group's heads; dS carried back past the first chunk
    is the initial state's gradient.

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) or (B, L,
    N) (G = 1); dy (B, L, H, P) the gradient of y; ``dstate`` (B, H, P, N)
    that of the final state (None: zero); ``initial_state`` (B, H, P, N)
    or None (zero) -> (dx, ddt, da, db, dc, d initial_state) in the
    inputs' dtypes, the last None where no initial state is given."""
    bb, l, h, p = x.shape
    b4, c4, g = ssd_groups(b, c, h)
    r, n = h // g, b4.shape[-1]
    q = chunk
    nc = -(-l // q)
    pad = nc * q - l

    def chunked(t: torch.Tensor) -> torch.Tensor:   # steps past L: dt = 0 identities
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bb, pad) + t.shape[2:])], dim=1)
        return t.reshape((bb, nc, q) + t.shape[2:])

    def heads(t: torch.Tensor) -> torch.Tensor:     # the head axis 3 as (G, R)
        return t.reshape(t.shape[:3] + (g, r) + t.shape[4:])

    xs, dts, dys = (heads(chunked(t)) for t in (x, dt, dy))           # (B, nc, Q, G, R, ...)
    bs, cs = chunked(b4), chunked(c4)                                # (B, nc, Q, G, N)
    af = a.float().reshape(g, r)
    cum = torch.cumsum(dts.double() * af.double(), dim=2)             # (B, nc, Q, G, R)
    total = cum[:, :, -1:]                                           # (B, nc, 1, G, R)
    ein = torch.exp(cum).float()                                     # e^{cs_i}
    wout = torch.exp(total - cum).float()                            # e^{cs_last - cs_j}
    keep = torch.exp(total[:, :, 0]).float()                         # (B, nc, G, R)
    seg = cum[:, :, :, None] - cum[:, :, None]                       # (B, nc, Q_i, Q_j, G, R)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[
        None, None, :, :, None, None]
    lmat = torch.where(causal, seg, -math.inf).exp().float()         # masked before the exp
    u = dts[..., None] * xs                                          # (B, nc, Q, G, R, P)

    # the state entering each chunk
    upd = torch.einsum("bcjgr,bcjgrp,bcjgn->bcgrpn", wout, u, bs)
    state = (torch.zeros((bb, g, r, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float().reshape(bb, g, r, p, n))
    s_prev = []
    for ci in range(nc):
        s_prev.append(state)
        state = keep[:, ci, ..., None, None] * state + upd[:, ci]
    s_prev = torch.stack(s_prev, dim=1)                              # (B, nc, G, R, P, N)

    # dS carried back: ds_out[c] is the gradient of the state leaving chunk c
    local = torch.einsum("bcigr,bcigrp,bcign->bcgrpn", ein, dys, cs)
    ds = (torch.zeros_like(state) if dstate is None
          else dstate.float().reshape(bb, g, r, p, n))
    ds_out = [None] * nc
    for ci in reversed(range(nc)):
        ds_out[ci] = ds
        ds = keep[:, ci, ..., None, None] * ds + local[:, ci]
    ds_out = torch.stack(ds_out, dim=1)                              # (B, nc, G, R, P, N)

    gm = torch.einsum("bcign,bcjgn->bcijg", cs, bs)                  # C_i . B_j per group
    w = gm[..., None] * lmat                                         # (B, nc, Q_i, Q_j, G, R)
    dyu = torch.einsum("bcigrp,bcjgrp->bcijgr", dys, u)              # dy_i . u_j
    v = lmat * dyu
    qm = w * dyu
    ds_b = torch.einsum("bcjgn,bcgrpn->bcjgrp", bs, ds_out)          # dS B_j
    du = torch.einsum("bcijgr,bcigrp->bcjgrp", w, dys) + wout[..., None] * ds_b
    carried = ein[..., None] * torch.einsum("bcigrp,bcgrpn->bcigrn", dys, s_prev)
    dc = torch.einsum("bcijgr,bcjgn->bcign", v, bs) + carried.sum(4)
    db = (torch.einsum("bcijgr,bcign->bcjgn", v, cs)
          + torch.einsum("bcjgr,bcjgrp,bcgrpn->bcjgn", wout * dts, xs, ds_out))
    rdot = torch.einsum("bcign,bcigrn->bcigr", cs, carried)
    tdot = wout * (u * ds_b).sum(-1)                                 # (B, nc, Q, G, R)
    sdot = (ds_out * s_prev).sum((-1, -2))                           # (B, nc, G, R)
    dcs = qm.sum(3) - qm.sum(2) + rdot - tdot
    dcs[:, :, -1] += tdot.sum(2) + keep * sdot
    dda = dcs.flip(2).cumsum(2).flip(2)                              # sum_{i >= k} dcs_i
    ddt = (xs * du).sum(-1) + af * dda
    da = (dts * dda).sum((0, 1, 2)).reshape(h)
    dx = dts[..., None] * du

    def unchunk(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.reshape((bb, nc * q) + like.shape[2:])[:, :l].to(like.dtype)

    ds0 = None if initial_state is None else ds.reshape(bb, h, p, n).to(initial_state.dtype)
    return (unchunk(dx, x), unchunk(ddt, dt), da.to(a.dtype), unchunk(db, b),
            unchunk(dc, c), ds0)
