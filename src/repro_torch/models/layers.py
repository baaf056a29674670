"""Core transformer layers: norms, RoPE, GQA self- and cross-attention,
multi-head latent attention (MLA), SwiGLU.

Ports ``src/repro/models/layers.py``.  ``params`` are dict trees (built
from the ParamDef trees in each ``make_*_defs``), activations are
tensors.  Matrix products promote their operands as JAX does (bf16 with
fp32 gives fp32), so a float32 config may run on bf16 weights.

Training/prefill attention is *blockwise*: on a CUDA tensor it is the
Hopper flash kernel (``kernels.ops.flash_attention``); on a CPU tensor
it is the reference's loop over query blocks, so the full (S × S) score
matrix is never built.  Decode uses ring-buffer KV caches, updated in
place (the reference returns a new cache tree).

Sliding-window layers (``swa``) pass ``window`` to the same kernel;
their decode cache is a ring buffer one window wide.  Cross-attention
(encoder-decoder) reads the encoder output without RoPE; its decode
attends to a fixed memory and leaves the cache as it is.

MLA (deepseek-v3) prefills through the same kernel with q/k dim
``qk_nope_head_dim + qk_rope_head_dim`` and v dim ``v_head_dim``; its
decode is the reference's absorbed form over the compressed latent cache
(``ckv`` and the shared roped key ``k_rope``), plain torch on every
device, as the reference computes it in jnp outside any Pallas kernel.
The activation-sharding context waits for the distribution slice
(ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention
from repro_torch.models.config import MLACfg, ModelConfig
from repro_torch.models.spec import ParamDef, pdef

NEG_INF = -1e30


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (bf16 @ fp32 -> fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands, with JAX's type promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # fp32-accumulated mean square (exact products of the activation
    # dtype); the scale and the (1 + w) weight are applied in x's dtype
    ms = torch.einsum("...d,...d->...", x.float(), x.float()) / x.shape[-1]
    scale = torch.rsqrt(ms + eps)[..., None].to(x.dtype)
    return x * scale * (1.0 + w).to(x.dtype)


def make_norm_def(d: int) -> ParamDef:
    # stored as (w - 1): init zeros => effective scale 1.0
    return pdef((d, "d_model"), init="zeros", dtype=torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) or (B, S, D); positions: (S,) or (B, S).  The
    split-halves layout (not interleaved), as the reference."""
    squeeze = x.dim() == 3
    if squeeze:                                        # (B, S, D) -> (B, S, 1, D)
        x = x[:, :, None, :]
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # ((B,)S, D/2)
    angles = angles[..., None, :]                      # head axis: ((B,)S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    return out[:, :, 0, :] if squeeze else out


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------


def make_ffn_defs(d_model: int, d_ff: int) -> dict[str, ParamDef]:
    return {
        "w1": pdef((d_model, "d_model"), (d_ff, "d_ff")),
        "w3": pdef((d_model, "d_model"), (d_ff, "d_ff")),
        "w2": pdef((d_ff, "d_ff"), (d_model, "d_model")),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, params["w1"])) * matmul(x, params["w3"])
    return matmul(h, params["w2"])


# ---------------------------------------------------------------------------
# attention parameter trees
# ---------------------------------------------------------------------------


def make_attention_defs(cfg: ModelConfig, *, cross: bool = False) -> dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": pdef((d, "d_model"), (h * hd, "heads")),
        "wk": pdef((d, "d_model"), (kv * hd, "kv_heads")),
        "wv": pdef((d, "d_model"), (kv * hd, "kv_heads")),
        "wo": pdef((h * hd, "heads"), (d, "d_model")),
    }


def make_mla_defs(cfg: ModelConfig) -> dict[str, Any]:
    m: MLACfg = cfg.mla  # type: ignore[assignment]
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": pdef((d, "d_model"), (m.q_lora_rank, None)),
        "q_norm": pdef((m.q_lora_rank, None), init="zeros", dtype=torch.float32),
        "wq_b": pdef((m.q_lora_rank, None), (h * m.qk_head_dim, "heads")),
        "wkv_a": pdef((d, "d_model"), (m.kv_lora_rank, None)),
        "kv_norm": pdef((m.kv_lora_rank, None), init="zeros", dtype=torch.float32),
        "wkv_b": pdef((m.kv_lora_rank, None),
                      (h * (m.qk_nope_head_dim + m.v_head_dim), "heads")),
        "wk_rope": pdef((d, "d_model"), (m.qk_rope_head_dim, None)),
        "wo": pdef((h * m.v_head_dim, "heads"), (d, "d_model")),
    }


# ---------------------------------------------------------------------------
# blockwise multi-head attention (training / prefill)
# ---------------------------------------------------------------------------


def _pick_q_block(s: int) -> int:
    for qb in (512, 256, 128, 64):
        if s % qb == 0 and s > qb:
            return qb
    return s


def _softmax_weights(scores: torch.Tensor, mask: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1).to(dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Dense attention with GQA and optional sliding window.

    q: (B, Sq, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) (Dv may
    differ: MLA).  Returns (B, Sq, H, Dv).  ``q_offset``: absolute
    position of q[0].
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    qh = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) / math.sqrt(d)
    qpos = (torch.arange(sq, device=q.device) + q_offset)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = _softmax_weights(scores, mask, q.dtype)
    return einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, sq, h, dv)


def blockwise_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k (B, Sk, KV, D) and v (B, Sk, KV,
    Dv): causal, windowed, or full (bidirectional, or cross-attention with
    Sk != S).  Returns (B, S, H, Dv).

    CUDA tensors go to the Hopper flash kernel, which takes MLA's q/k dim
    192 with v dim 128 as well as D = Dv; CPU tensors take the reference's
    loop over query blocks, reading only the (window + qb)-wide KV slice
    per block for sliding-window attention.
    """
    b, s, h, d = q.shape
    dv = v.shape[-1]
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    qb = _pick_q_block(s)
    if qb == s:
        return mha(q, k, v, causal=causal, window=window)
    outs = []
    for i in range(s // qb):
        qi = q[:, i * qb:(i + 1) * qb]
        if window and window + qb <= s:
            ctx = window + qb
            start = min(max(i * qb + qb - ctx, 0), s - ctx)
            outs.append(mha(qi, k[:, start:start + ctx], v[:, start:start + ctx],
                            causal=causal, window=window, q_offset=i * qb - start))
        else:
            outs.append(mha(qi, k, v, causal=causal, window=window, q_offset=i * qb))
    return torch.cat(outs, dim=1).reshape(b, s, h, dv)


# ---------------------------------------------------------------------------
# head padding (see ModelConfig.head_pad)
# ---------------------------------------------------------------------------


def _pad_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Pad q heads to cfg.head_pad and expand kv to the same count (MHA
    layout).  Returns the original head count for the caller to slice
    the output back."""
    h = q.shape[-2]
    hp = cfg.head_pad
    if not hp or hp <= h:
        return q, k, v, h
    kvh = k.shape[-2]
    if kvh != h:                              # GQA -> full MHA expansion
        k = k.repeat_interleave(h // kvh, dim=-2)
        v = v.repeat_interleave(h // kvh, dim=-2)
    pad = (0, 0, 0, hp - h)                   # (last dim, head dim)
    return F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), h


# ---------------------------------------------------------------------------
# full attention blocks (train / prefill path)
# ---------------------------------------------------------------------------


def attention_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    window: int = 0, bidirectional: bool = False,
                    kv_source: torch.Tensor | None = None, return_kv: bool = False):
    """Self- (or cross-) attention over a full sequence.

    window: sliding-window self-attention (``swa``): query q sees keys
    k with q - window < k <= q.
    bidirectional: no causal mask (encoder self-attention).
    kv_source: if given (encoder output, (B, Sk, d)), cross-attention
    without RoPE and without a mask.
    return_kv: also return the K/V for prefill cache capture (roped for
    self-attention, as computed for cross-attention).
    """
    b, s, _ = x.shape
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    src = x if kv_source is None else kv_source
    sk = src.shape[1]
    q = matmul(x, params["wq"]).reshape(b, s, h, hd)
    k = matmul(src, params["wk"]).reshape(b, sk, kv, hd)
    v = matmul(src, params["wv"]).reshape(b, sk, kv, hd)
    if kv_source is None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kv_for_cache = {"k": k, "v": v}
    q, k, v, h_orig = _pad_heads(q, k, v, cfg)
    out = blockwise_mha(q, k, v, causal=kv_source is None and not bidirectional,
                        window=window)
    out = out[..., :h_orig, :]
    out = matmul(out.reshape(b, s, h * hd), params["wo"])
    if return_kv:
        return out, kv_for_cache
    return out


def mla_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              return_cache: bool = False):
    """DeepSeek-V3 multi-head latent attention over a full sequence (the
    train / prefill path): q and the latent ``ckv`` through their low-rank
    projections and norms, per-head K and V from ``ckv``, a roped key
    shared by all heads, causal attention of q/k dim ``qk_head_dim`` over v
    dim ``v_head_dim``.  ``return_cache``: also the decode cache, ``ckv``
    (B, S, kv_lora_rank) and the roped ``k_rope`` (B, S, qk_rope_head_dim)."""
    m: MLACfg = cfg.mla  # type: ignore[assignment]
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = torch.arange(s, device=x.device)
    cq = rms_norm(matmul(x, params["wq_a"]), params["q_norm"], cfg.norm_eps)
    q = matmul(cq, params["wq_b"]).reshape(b, s, h, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    ckv = rms_norm(matmul(x, params["wkv_a"]), params["kv_norm"], cfg.norm_eps)
    kvu = matmul(ckv, params["wkv_b"]).reshape(b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvu.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope = apply_rope(matmul(x, params["wk_rope"]), pos, cfg.rope_theta)   # (B, S, rope)

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)],
                       dim=-1)
    out = blockwise_mha(q_full, k_full, v, causal=True)
    out = matmul(out.reshape(b, s, h * m.v_head_dim), params["wo"])
    if return_cache:
        return out, {"ckv": ckv, "k_rope": k_rope}
    return out


# ---------------------------------------------------------------------------
# decode (single new token against a ring-buffer cache)
# ---------------------------------------------------------------------------


def attention_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
                     cross_memory: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d).  cache: {"k","v": (B, Smax, KV, hd), "len": ()}.

    Ring-buffer semantics: the new KV overwrites slot ``len % Smax`` and
    the query attends to the ``min(len + 1, Smax)`` filled slots.  A
    sliding-window layer's buffer is ``min(window, seq_len)`` wide, so
    its window is implicit in the buffer's width (the reference takes a
    ``window`` argument here and does not read it).  ``len`` is one
    scalar per layer, shared by the whole batch, as in the reference.
    The cache is updated in place and returned.
    Cross-attention (enc-dec) passes ``cross_memory`` = {"k","v"} instead:
    the query attends to all of it, unroped, and the cache is untouched.
    """
    b = x.shape[0]
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = matmul(x, params["wq"]).reshape(b, 1, h, hd)
    if cross_memory is not None:
        out = mha(q, cross_memory["k"], cross_memory["v"], causal=False)
        return matmul(out.reshape(b, 1, h * hd), params["wo"]), cache
    smax = cache["k"].shape[1]
    cur = cache["len"].reshape(1)                       # int32, on the device
    k_new = matmul(x, params["wk"]).reshape(b, 1, kvh, hd)
    v_new = matmul(x, params["wv"]).reshape(b, 1, kvh, hd)
    q = apply_rope(q, cur, cfg.rope_theta)
    k_new = apply_rope(k_new, cur, cfg.rope_theta)
    slot = torch.remainder(cur, smax).long()
    n_valid = torch.clamp(cur + 1, max=smax)
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(1, slot, k_new.to(ck.dtype))
    cv.index_copy_(1, slot, v_new.to(cv.dtype))
    # scores over the whole buffer; invalid slots masked via n_valid
    g = h // kvh
    qh = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), ck.float()) / math.sqrt(hd)
    mask = torch.arange(smax, device=x.device)[None, :] < n_valid
    p = _softmax_weights(scores, mask, x.dtype)
    out = einsum("bkgqs,bskd->bqkgd", p, cv).reshape(b, 1, h * hd)
    cache["len"].add_(1)
    return matmul(out, params["wo"]), cache


def mla_decode(params: dict, x: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Absorbed MLA decode: x (B, 1, d) against the compressed latent cache
    {"ckv": (B, Smax, kv_lora_rank), "k_rope": (B, Smax, rope), "len": ()}
    without materialising per-head K/V.  q_nope is folded through
    ``wkv_b``'s K half, scores are taken against ``ckv`` and ``k_rope``
    (scaled by 1 / sqrt(qk_head_dim)), and the context over ``ckv`` is
    projected through the V half.  Ring-buffer slots as
    :func:`attention_decode`; the cache is updated in place and returned."""
    m: MLACfg = cfg.mla  # type: ignore[assignment]
    b = x.shape[0]
    h = cfg.n_heads
    smax = cache["ckv"].shape[1]
    cur = cache["len"].reshape(1)                       # int32, on the device

    cq = rms_norm(matmul(x, params["wq_a"]), params["q_norm"], cfg.norm_eps)
    q = matmul(cq, params["wq_b"]).reshape(b, 1, h, m.qk_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, cur, cfg.rope_theta)

    ckv_new = rms_norm(matmul(x, params["wkv_a"]), params["kv_norm"], cfg.norm_eps)
    kr_new = apply_rope(matmul(x, params["wk_rope"]), cur, cfg.rope_theta)
    slot = torch.remainder(cur, smax).long()
    ckv, krope = cache["ckv"], cache["k_rope"]
    ckv.index_copy_(1, slot, ckv_new.to(ckv.dtype))
    krope.index_copy_(1, slot, kr_new.to(krope.dtype))

    # absorb wkv_b's K half into q_nope: q_abs (B, 1, H, kv_lora_rank)
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_k, w_v = wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_abs = einsum("bqhd,rhd->bqhr", q_nope, w_k)
    # fp32 scores of the operands' exact products, as the reference's
    # preferred_element_type=float32
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv.float())
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), krope.float()))
    scores = scores / math.sqrt(m.qk_head_dim)
    n_valid = torch.clamp(cur + 1, max=smax)
    mask = torch.arange(smax, device=x.device)[None, :] < n_valid
    p = _softmax_weights(scores, mask, x.dtype)
    ctx = einsum("bhqs,bsr->bqhr", p, ckv)                    # (B, 1, H, r)
    out = einsum("bqhr,rhd->bqhd", ctx, w_v).reshape(b, 1, h * m.v_head_dim)
    cache["len"].add_(1)
    return matmul(out, params["wo"]), cache
