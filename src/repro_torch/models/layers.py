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

Activation sharding is injected through :func:`constrain`, which consults
the active sharding context (``distributed.sharding.activation_sharding``);
without a context it is the identity, so models run unmodified on one
device.  Under a context the parameters and activations are DTensors over
its ``DeviceMesh``.  Two things that XLA's partitioner does by itself are
asked for here: a weight sharded over the data axes (FSDP) is gathered over
them where :func:`matmul` uses it, keeping its ``model`` sharding; and a
projection is laid out for its head view before the view
(:func:`split_heads`), since DTensor cannot split a dim sharded more ways
than its heads divide.
"""
from __future__ import annotations

import contextvars
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention
from repro_torch.models.config import MLACfg, ModelConfig
from repro_torch.models.spec import ParamDef, pdef

NEG_INF = -1e30
#: logical axes of q grouped by kv head, (B, S, KV, G, D): a GQA view of q
#: keeps only a sharding that the kv heads divide
GROUPED_AXES = ("batch", "seq", "kv_heads", None, None)

# ---------------------------------------------------------------------------
# activation-sharding context
# ---------------------------------------------------------------------------

_SHARD_CTX: contextvars.ContextVar[Callable[[torch.Tensor, tuple], torch.Tensor] | None] = \
    contextvars.ContextVar("wrath_shard_ctx", default=None)
# (mesh, rules) for code that needs explicit collectives (shard_map MoE) or
# the layout of a shape it is about to make (split_heads, the kernels)
_MESH_CTX: contextvars.ContextVar[tuple[Any, Any] | None] = \
    contextvars.ContextVar("wrath_mesh_ctx", default=None)


def set_shard_fn(fn: Callable[[torch.Tensor, tuple], torch.Tensor] | None,
                 mesh: Any | None = None, rules: Any | None = None):
    token2 = _MESH_CTX.set(None if mesh is None else (mesh, rules))
    return _SHARD_CTX.set(fn), token2


def reset_shard_fn(token) -> None:
    t1, t2 = token if isinstance(token, tuple) else (token, None)
    _SHARD_CTX.reset(t1)
    if t2 is not None:
        _MESH_CTX.reset(t2)


def current_mesh():
    ctx = _MESH_CTX.get()
    return None if ctx is None else ctx[0]


def constrain(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    fn = _SHARD_CTX.get()
    return fn(x, axes) if fn is not None else x


def is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def layout_for(shape: tuple[int, ...], axes: tuple[str | None, ...]) -> list | None:
    """DTensor placements the active context gives a tensor of ``shape``
    with logical ``axes``; None without a context."""
    ctx = _MESH_CTX.get()
    if ctx is None:
        return None
    from repro_torch.distributed.sharding import placements_for, spec_for

    mesh, rules = ctx
    return placements_for(spec_for(shape, axes, rules, mesh), len(shape), mesh)


def to_layout(t: torch.Tensor, placements: list) -> torch.Tensor:
    """Redistribute DTensor ``t`` to ``placements`` (no-op when it has them)."""
    if list(t.placements) == list(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def gather_fsdp(w: torch.Tensor, x: torch.Tensor | None = None) -> torch.Tensor:
    """A weight at its use ``x @ w``: under a mesh, gathered over the data
    axes it is sharded on (FSDP), keeping its ``model`` sharding; anything
    else as it is.  Where the tokens ``x`` have a batch dim sharded over
    ``model`` too (pure data parallelism: ``launch/dryrun.py``'s override
    for small dense models) and ``w``'s matrix dims are sharded over it,
    the weight is gathered whole, as ZeRO-3 does; a sharding of ``w``'s own
    batch dims (the experts of a batched product) stays."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    def gathered(name: str, p, xp) -> bool:
        if not p.is_shard():
            return False
        tokens_too = xp is not None and xp.is_shard() and xp.dim < x.dim() - 1
        return name != "model" or (tokens_too and p.dim >= w.dim() - 2)

    names = w.device_mesh.mesh_dim_names
    xpl = x.placements if is_dtensor(x) else (None,) * len(names)
    return to_layout(w, [Replicate() if gathered(n, p, xp) else p
                         for n, p, xp in zip(names, w.placements, xpl)])


def split_heads(t: torch.Tensor, shape: tuple[int, ...],
                axes: tuple[str | None, ...]) -> torch.Tensor:
    """``t.reshape(shape)`` where ``shape`` splits t's last dim in (heads,
    head_dim).  Under a mesh, ``t`` is first laid out as the context gives
    the viewed shape: its heads dim sharded only as far as the heads
    divide (a projection over 8 kv heads on a 16-way ``model`` axis is
    gathered), which XLA reshards by itself and DTensor does not."""
    pl = layout_for(shape, axes) if is_dtensor(t) else None
    if pl is not None:
        # the head_dim axis is never sharded, so Shard(heads) of the view
        # is Shard of t's last dim, and every other dim keeps its index
        t = to_layout(t, pl)
    return t.reshape(shape)


def _block_of(t: torch.Tensor, dim: int) -> tuple[list[int], int]:
    """(the mesh dims that shard DTensor ``t``'s ``dim``, the index of this
    rank's block along it: the blocks of several mesh dims nest in mesh
    order)."""
    mesh = t.device_mesh
    coord, block, dims = mesh.get_coordinate(), 0, []
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            block = block * mesh.size(i) + coord[i]
            dims.append(i)
    return dims, block


def take_rows(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``, the table gathered over its FSDP axes.
    Under a mesh a vocab-sharded table stays so: each rank looks up the ids
    in its block of rows (zeros for the others) and the rows come out as a
    partial sum over the vocab's mesh dims, which the caller's constrain
    reduces.  (DTensor's own masked embedding has no backward through a
    redistribution.)"""
    table = gather_fsdp(table, ids)
    if not is_dtensor(table) or not any(p.is_shard(0) for p in table.placements):
        return F.embedding(ids, table)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    tpl = list(table.placements)
    vocab_dims, block = _block_of(table, 0)
    ipl = [Replicate() if i in vocab_dims else p for i, p in enumerate(ids.placements)]
    out = [Partial() if i in vocab_dims else p for i, p in enumerate(ipl)]
    # the table's gradient: a sum over the ranks that hold other ids
    grad = [Partial() if q.is_shard() and not p.is_shard() else p
            for p, q in zip(tpl, ids.placements)]

    def local(ids_l, tab_l):
        rows = tab_l.shape[0]
        local_ids = ids_l - block * rows
        mine = (local_ids >= 0) & (local_ids < rows)
        return F.embedding(torch.where(mine, local_ids, 0), tab_l) * mine[..., None]

    return local_map(local, out_placements=out, in_placements=(ipl, tpl),
                     in_grad_placements=(ipl, grad), device_mesh=table.device_mesh)(
        to_layout(ids, ipl), table)


def take_along_vocab(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits[..., idx]`` per position (``torch.gather`` on the last dim).
    Under a mesh each rank takes its positions' targets from its shard (and
    where the vocab is sharded, those that fall in its block, zeros for the
    others: a partial sum over the vocab's mesh dims, as :func:`take_rows`).
    DTensor's own gather gathers the logits' batch in its backward."""
    last = logits.dim() - 1
    if not is_dtensor(logits):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    lpl = list(logits.placements)
    vocab_dims, block = _block_of(logits, last)
    ipl = [Replicate() if i in vocab_dims else p for i, p in enumerate(lpl)]
    out = [Partial() if i in vocab_dims else p for i, p in enumerate(ipl)]

    def local(lg, ix):
        n = lg.shape[-1]
        local_ix = ix - block * n
        mine = (local_ix >= 0) & (local_ix < n)
        picked = torch.gather(lg, -1, torch.where(mine, local_ix, 0)[..., None])[..., 0]
        return picked * mine

    return local_map(local, out_placements=out, in_placements=(lpl, ipl),
                     device_mesh=logits.device_mesh)(logits, to_layout(idx, ipl))


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over ``group`` into a value every rank then uses
    whole; its gradient is the same on every rank and passes through (an
    all-reduce of it would count it once a rank)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol

        out = funcol.all_reduce(t, "sum", group)
        return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def logsumexp_vocab(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(logits, -1)``.  Under a mesh with the vocab
    sharded, each rank reduces its block: the max and the sum of
    exponentials are all-reduced over the vocab's mesh dims, so the logits
    are never gathered (DTensor's own logsumexp gathers them whole)."""
    last = logits.dim() - 1
    if not is_dtensor(logits) or not any(p.is_shard(last) for p in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    lpl = list(logits.placements)
    vocab_dims, _ = _block_of(logits, last)
    groups = [mesh[mesh.mesh_dim_names[i]] for i in vocab_dims]
    out = [Replicate() if i in vocab_dims else p for i, p in enumerate(lpl)]

    def local(lg):
        top = lg.detach().amax(-1, keepdim=True)     # any constant shift is exact
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        total = torch.exp(lg - top).sum(-1, keepdim=True)
        for g in groups:
            total = _SumOverRanks.apply(total, g)
        return (top + torch.log(total))[..., 0]

    return local_map(local, out_placements=out, in_placements=(lpl,),
                     device_mesh=mesh)(logits)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (bf16 @ fp32 -> fp32); under a
    mesh the weight is gathered over its FSDP axes first."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ gather_fsdp(w, x).to(dt)


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


def swiglu(params: dict, x: torch.Tensor,
           axes: tuple[str | None, ...] = ("batch", "seq", "d_ff")) -> torch.Tensor:
    """SwiGLU; ``axes``: the logical axes of its hidden activation."""
    h = F.silu(matmul(x, params["w1"])) * matmul(x, params["w3"])
    h = constrain(h, axes)
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


def ring_write(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[:, slot] = new`` in place (a decode cache's ring-buffer write;
    ``slot`` a one-element index tensor, ``new`` one step).  Under a mesh
    the buffer's sequence dim may be sharded: each rank writes the step
    into its own block when the slot falls there and rewrites what it holds
    otherwise, so no rank reads the slot back to the host."""
    if not is_dtensor(buf):
        buf.index_copy_(1, slot, new.to(buf.dtype))
        return
    from torch.distributed.tensor import Replicate

    new = to_layout(new, [Replicate() if p.is_shard(1) else p for p in buf.placements])
    local, step = buf.to_local(), new.to_local().to(buf.dtype)
    idx = slot.to_local() if is_dtensor(slot) else slot
    idx = idx - _block_of(buf, 1)[1] * local.shape[1]
    mine = (idx >= 0) & (idx < local.shape[1])
    idx = torch.where(mine, idx, 0)
    mine = mine.view([1, 1] + [1] * (step.dim() - 2))
    local.index_copy_(1, idx, torch.where(mine, step, local.index_select(1, idx)))


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
    192 with v dim 128 as well as D = Dv; so do DTensors (the kernel's
    wrapper runs on each rank's shard) and meta tensors (the dry-run).
    CPU tensors take the reference's loop over query blocks, reading only
    the (window + qb)-wide KV slice per block for sliding-window attention.
    """
    b, s, h, d = q.shape
    dv = v.shape[-1]
    if q.device.type != "cpu" or is_dtensor(q):
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
    q_axes = ("batch", "seq", "heads", None)
    kv_axes = ("batch", "seq", "kv_heads", None)
    q = split_heads(matmul(x, params["wq"]), (b, s, h, hd), q_axes)
    k = split_heads(matmul(src, params["wk"]), (b, sk, kv, hd), kv_axes)
    v = split_heads(matmul(src, params["wv"]), (b, sk, kv, hd), kv_axes)
    if kv_source is None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kv_for_cache = {"k": k, "v": v}
    q, k, v, h_orig = _pad_heads(q, k, v, cfg)
    q = constrain(q, q_axes)
    k = constrain(k, q_axes if cfg.head_pad else kv_axes)
    v = constrain(v, q_axes if cfg.head_pad else kv_axes)
    out = blockwise_mha(q, k, v, causal=kv_source is None and not bidirectional,
                        window=window)
    out = out[..., :h_orig, :]
    out = constrain(out, q_axes)
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
    axes = ("batch", "seq", "heads", None)
    cq = rms_norm(matmul(x, params["wq_a"]), params["q_norm"], cfg.norm_eps)
    q = split_heads(matmul(cq, params["wq_b"]), (b, s, h, m.qk_head_dim), axes)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    ckv = rms_norm(matmul(x, params["wkv_a"]), params["kv_norm"], cfg.norm_eps)
    kvu = split_heads(matmul(ckv, params["wkv_b"]),
                      (b, s, h, m.qk_nope_head_dim + m.v_head_dim), axes)
    k_nope, v = kvu.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope = apply_rope(matmul(x, params["wk_rope"]), pos, cfg.rope_theta)   # (B, S, rope)

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)],
                       dim=-1)
    q_full = constrain(q_full, axes)
    k_full = constrain(k_full, axes)
    out = blockwise_mha(q_full, k_full, v, causal=True)
    out = constrain(out, axes)
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
    q = split_heads(matmul(x, params["wq"]), (b, 1, h, hd), ("batch", "seq", "heads", None))
    if cross_memory is not None:
        mk, mv = cross_memory["k"], cross_memory["v"]
        if is_dtensor(mk):
            qh = split_heads(q, (b, 1, kvh, h // kvh, hd), GROUPED_AXES)
            out = _attend_cache_on_mesh(qh, mk, mv, mk.shape[1], x.dtype)
        else:
            out = mha(q, mk, mv, causal=False)
        return matmul(out.reshape(b, 1, h * hd), params["wo"]), cache
    smax = cache["k"].shape[1]
    cur = cache["len"].reshape(1)                       # int32, on the device
    kv_axes = ("batch", "seq", "kv_heads", None)
    k_new = split_heads(matmul(x, params["wk"]), (b, 1, kvh, hd), kv_axes)
    v_new = split_heads(matmul(x, params["wv"]), (b, 1, kvh, hd), kv_axes)
    q = apply_rope(q, cur, cfg.rope_theta)
    k_new = apply_rope(k_new, cur, cfg.rope_theta)
    slot = torch.remainder(cur, smax).long()
    n_valid = torch.clamp(cur + 1, max=smax)
    ck, cv = cache["k"], cache["v"]
    ring_write(ck, slot, k_new)
    ring_write(cv, slot, v_new)
    # scores over the whole buffer; invalid slots masked via n_valid
    g = h // kvh
    qh = split_heads(q, (b, 1, kvh, g, hd), GROUPED_AXES)
    if is_dtensor(ck):
        out = _attend_cache_on_mesh(qh, ck, cv, n_valid, x.dtype)
    else:
        scores = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), ck.float()) / math.sqrt(hd)
        mask = torch.arange(smax, device=x.device)[None, :] < n_valid
        p = _softmax_weights(scores, mask, x.dtype)
        out = einsum("bkgqs,bskd->bqkgd", p, cv)
    cache["len"].add_(1)
    return matmul(out.reshape(b, 1, h * hd), params["wo"]), cache


def _attend_cache_on_mesh(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          n_valid: torch.Tensor | int, dtype: torch.dtype) -> torch.Tensor:
    """One decode step's attention of q (B, 1, KV, G, D) over a cache whose
    sequence dim may be sharded (CACHE_RULES: over ``model``), on each
    rank's shard: every rank scores its block of slots, the softmax's max
    and sum are all-reduced over the ranks that share the sequence, and
    the rank's share of P·V leaves as a partial sum.  (DTensor's own
    search for a sharding of these 5-dim products takes minutes on a 3-dim
    mesh.)  ``n_valid``: the filled slots, a replicated scalar DTensor or an
    int (a cross-attention memory, all filled).  Returns (B, 1, KV, G, D)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = ck.device_mesh
    seq_dims, block = _block_of(ck, 1)
    qpl = [p if p.is_shard(0) else Replicate() for p in ck.placements]
    kvpl = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in ck.placements]
    out = [Partial() if i in seq_dims else p for i, p in enumerate(qpl)]
    rep = [Replicate()] * mesh.ndim

    def local(q_l, k_l, v_l, nv):
        n = k_l.shape[1]
        scores = torch.einsum("bqkgd,bskd->bkgqs", q_l.float(), k_l.float()) / math.sqrt(
            q_l.shape[-1])
        kpos = block * n + torch.arange(n, device=k_l.device)
        scores = scores.masked_fill(~(kpos < nv)[None, :], NEG_INF)
        top = scores.amax(-1, keepdim=True)
        for i in seq_dims:
            top = funcol.all_reduce(top, "max", mesh[mesh.mesh_dim_names[i]])
        e = torch.exp(scores - top)
        total = e.sum(-1, keepdim=True)
        for i in seq_dims:
            total = funcol.all_reduce(total, "sum", mesh[mesh.mesh_dim_names[i]])
        return einsum("bkgqs,bskd->bqkgd", (e / total).to(dtype), v_l)

    nv = to_layout(n_valid, rep) if is_dtensor(n_valid) else n_valid
    return local_map(local, out_placements=out,
                     in_placements=(qpl, kvpl, kvpl, rep if is_dtensor(nv) else None),
                     device_mesh=mesh)(to_layout(q, qpl), to_layout(ck, kvpl),
                                       to_layout(cv, kvpl), nv)


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
    q = split_heads(matmul(cq, params["wq_b"]), (b, 1, h, m.qk_head_dim),
                    ("batch", "seq", "heads", None))
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, cur, cfg.rope_theta)

    ckv_new = rms_norm(matmul(x, params["wkv_a"]), params["kv_norm"], cfg.norm_eps)
    kr_new = apply_rope(matmul(x, params["wk_rope"]), cur, cfg.rope_theta)
    slot = torch.remainder(cur, smax).long()
    ckv, krope = cache["ckv"], cache["k_rope"]
    ring_write(ckv, slot, ckv_new)
    ring_write(krope, slot, kr_new)

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
