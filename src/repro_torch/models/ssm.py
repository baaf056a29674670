"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Ports ``src/repro/models/ssm.py``.  Training/prefill path: the chunked
SSD algorithm (an intra-chunk "attention-like" quadratic term plus an
inter-chunk linear state recurrence).  On a CUDA tensor the scan is the
Hopper kernel (``kernels.ops.ssd_scan``); on a CPU tensor it is a torch
mirror of the reference's jnp op, with a Python loop over chunks where
the reference runs ``lax.scan``.  Decode path: the O(1) per-token state
update, as plain tensor code (the reference has no decode kernel).

Block structure (Mamba-2): in_proj -> (z, x, B, C, dt); depthwise causal
conv over (x, B, C); SSD core; gated RMSNorm; out_proj.  Under an
activation-sharding context (``models/layers.py``) the scan's values are
laid out over batch and heads and the scan runs on each rank's shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_scan as ssd_scan_kernel
from repro_torch.models.config import ModelConfig, SSMCfg
from repro_torch.models.layers import constrain, is_dtensor, matmul, rms_norm, split_heads
from repro_torch.models.spec import pdef


def ssm_dims(cfg: ModelConfig) -> dict[str, int]:
    s: SSMCfg = cfg.ssm  # type: ignore[assignment]
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        "d_inner": d_inner,
        "n_heads": n_heads,
        "conv_dim": conv_dim,
        "d_in_proj": 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads,
    }


def make_ssd_defs(cfg: ModelConfig) -> dict:
    s: SSMCfg = cfg.ssm  # type: ignore[assignment]
    dims = ssm_dims(cfg)
    return {
        "in_proj": pdef((cfg.d_model, "d_model"), (dims["d_in_proj"], "heads")),
        "conv_w": pdef((s.conv_width, None), (dims["conv_dim"], "heads"), scale=0.5),
        "conv_b": pdef((dims["conv_dim"], "heads"), init="zeros"),
        "a_log": pdef((dims["n_heads"], "heads"), init="ones", dtype=torch.float32),
        "d_skip": pdef((dims["n_heads"], "heads"), init="ones", dtype=torch.float32),
        "dt_bias": pdef((dims["n_heads"], "heads"), init="zeros", dtype=torch.float32),
        "norm": pdef((dims["d_inner"], "heads"), init="zeros", dtype=torch.float32),
        "out_proj": pdef((dims["d_inner"], "heads"), (cfg.d_model, "d_model")),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) lower-tri pairwise cumulative sums:
    out[..., i, j] = sum(a[..., j+1 : i+1]) for i >= j, -inf above the
    diagonal (masked before any exp, so nothing overflows)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s type promotion: operands go to their common dtype."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, chunk: int,
                      initial_state: torch.Tensor | None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's jnp chunked op, step for step."""
    bb, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    rep = h // g

    xc = x.reshape(bb, nc, chunk, h, p)
    dtc = dt.reshape(bb, nc, chunk, h)
    bc = b.reshape(bb, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c.reshape(bb, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtc * a[None, None, None, :]                    # (B,nc,Q,H)
    da_cs = torch.cumsum(da, dim=2)                      # within-chunk cumsum
    # intra-chunk (diagonal blocks): attention-like with decay mask
    lmask = torch.exp(_segsum(da.permute(0, 1, 3, 2)))   # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]
    y_diag = _einsum("bcqhn,bckhn,bchqk,bckhp->bcqhp", cc, bc, lmask, xdt)

    # per-chunk end states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B,nc,Q,H)
    states = _einsum("bckhn,bckh,bckhp->bchpn", bc, decay_states, xdt)

    # inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])          # (B,nc,H)
    s = (initial_state if initial_state is not None
         else torch.zeros((bb, h, p, n), dtype=x.dtype, device=x.device)).float()
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci].float()
    s_prev = torch.stack(s_prevs, dim=1).to(x.dtype)     # (B,nc,H,P,N)

    # off-diagonal contribution from the carried state
    state_decay = torch.exp(da_cs)                       # (B,nc,Q,H)
    y_off = _einsum("bcqhn,bchpn,bcqh->bcqhp", cc, s_prev, state_decay)
    y = (y_diag + y_off).reshape(bb, l, h, p)
    return y, s.to(x.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int, initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x:  (B, L, H, P) values
    dt: (B, L, H)    softplus'd step sizes
    a:  (H,)         negative decay rates (A = -exp(a_log))
    b:  (B, L, G, N) input projections  (broadcast G -> H)
    c:  (B, L, G, N) output projections
    Returns (y (B, L, H, P), final_state (B, H, P, N)).

    CUDA tensors go to the Hopper kernel, which takes G == 1 and no
    initial state (what the model passes); anything else raises there
    rather than take the mirror.  So do DTensors (the wrapper runs the
    kernel, or on CPU shards its plain version, on each rank's shard) and
    meta tensors (the dry-run's abstract evaluation).  CPU tensors run the
    reference's chunked op.
    """
    l, g = x.shape[1], b.shape[2]
    assert l % chunk == 0, f"L={l} not divisible by chunk={chunk}"
    if x.device.type != "cpu" or is_dtensor(x):
        if g != 1 or initial_state is not None:
            raise NotImplementedError(
                "the SSD kernel takes one B/C group and no initial state: "
                "ROADMAP.md, Queue 2 item 4")
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
            raise NotImplementedError(
                "the SSD kernel has no backward yet: ROADMAP.md, Queue 2 item 5")
        # x, b and c stay views of the conv output: the kernel reads them in place
        return ssd_scan_kernel(x, dt, a, b, c, chunk=chunk)
    return _ssd_scan_chunked(x, dt, a, b, c, chunk, initial_state)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, L, C); w: (W, C).

    Returns (y (B,L,C), new_state (B, W-1, C)) — state carries the last
    W-1 inputs for decode continuation.
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                    # (B, L+W-1, C), promoted
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return F.silu(y + bias[None, None]), new_state


def _split_in_proj(zxbcdt: torch.Tensor, dims: dict, gn: int):
    """in_proj output -> (z, x, B|C, dt_raw)."""
    d = dims["d_inner"]
    return torch.split(zxbcdt, [d, d, 2 * gn, dims["n_heads"]], dim=-1)


def ssd_block_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    return_state: bool = False):
    s: SSMCfg = cfg.ssm  # type: ignore[assignment]
    dims = ssm_dims(cfg)
    bsz, l, _ = x.shape
    h, p, n, g = dims["n_heads"], s.head_dim, s.d_state, s.n_groups

    z, xin, bc_in, dt_raw = _split_in_proj(matmul(x, params["in_proj"]), dims, g * n)
    conv_in = torch.cat([xin, bc_in], dim=-1)
    conv_out, _ = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    xin, b_in, c_in = torch.split(conv_out, [dims["d_inner"], g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["a_log"])
    xh = split_heads(xin, (bsz, l, h, p), ("batch", "seq", "heads", None))
    xh = constrain(xh, ("batch", "seq", "heads", None))
    y, final_state = ssd_scan(xh, dt.to(x.dtype), a.to(x.dtype),
                              b_in.reshape(bsz, l, g, n), c_in.reshape(bsz, l, g, n),
                              chunk=min(s.chunk, l))
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, l, dims["d_inner"])
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = matmul(y, params["out_proj"])
    if return_state:
        conv_state = conv_in[:, -(s.conv_width - 1):]
        return out, {"conv": conv_state, "state": final_state}
    return out


def ssd_block_decode(params: dict, x: torch.Tensor, cache: dict,
                     cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Single-token update.  cache: {"conv": (B, W-1, conv_dim),
    "state": (B, H, P, N)}.  A leaf is updated in place and returned, as
    attention's cache is, where its dtype holds the step's result.  Where
    the step widens it (a bf16 leaf under fp32 activations, as the
    reference's step promotes it), the new value is a new tensor."""
    s: SSMCfg = cfg.ssm  # type: ignore[assignment]
    dims = ssm_dims(cfg)
    bsz = x.shape[0]
    h, p, n, g = dims["n_heads"], s.head_dim, s.d_state, s.n_groups

    z, xin, bc_in, dt_raw = _split_in_proj(matmul(x, params["in_proj"]), dims, g * n)
    conv_in = torch.cat([xin, bc_in], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                        state=cache["conv"])
    if conv_state.dtype == cache["conv"].dtype:
        conv_state = cache["conv"].copy_(conv_state)
    xin, b_in, c_in = torch.split(conv_out, [dims["d_inner"], g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])[:, 0]   # (B,H)
    a = -torch.exp(params["a_log"])                      # (H,)
    xh = xin.reshape(bsz, h, p)
    bh = b_in.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)          # (B,H,N)
    ch = c_in.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)
    decay = torch.exp(dt * a[None]).to(x.dtype)[..., None, None]           # (B,H,1,1)
    # broadcast products, not einsums: DTensor's sharding search over a
    # multi-operand einsum on a 3-D mesh takes minutes
    upd = (xh * dt.to(x.dtype)[..., None])[..., None] * bh[:, :, None, :]
    state = cache["state"]
    if torch.promote_types(state.dtype, x.dtype) == state.dtype:
        state = state.mul_(decay).add_(upd)
    else:
        state = state * decay + upd
    y = (state * ch[:, :, None, :].to(state.dtype)).sum(-1)
    y = y + params["d_skip"].to(x.dtype)[None, :, None] * xh
    y = y.reshape(bsz, 1, dims["d_inner"])
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return matmul(y, params["out_proj"]), {"conv": conv_state, "state": state}
