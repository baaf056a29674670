"""RG-LRU recurrent block (Griffin / RecurrentGemma — arXiv:2402.19427).

Ports ``src/repro/models/griffin.py``.  Block structure (the Griffin
"recurrent block"): two parallel linear branches from the input; branch
1 -> GeLU gate; branch 2 -> depthwise causal conv -> RG-LRU; elementwise
product; output projection.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t)                     (recurrence gate)
    i_t = sigmoid(W_x x_t)                     (input gate)
    log a_t = -c * softplus(Lambda) * r_t      (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill scan the sequence in fp32 with a log-depth
associative scan of whole tensors (:func:`_linear_scan`, where the
reference calls ``jax.lax.associative_scan``): ceil(log2 L) passes, not a
loop over L.  The reference has no Pallas kernel here, so neither device
has one; the scan is plain tensor code on both.  Decode is the O(1)
update, with the carried state ``h`` kept in the activations' dtype, as
the reference keeps it.  The reference's activation-sharding
``constrain`` has no counterpart yet, as in ``models/layers.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, RGLRUCfg
from repro_torch.models.layers import matmul
from repro_torch.models.spec import pdef

_C = 8.0


def rglru_dims(cfg: ModelConfig) -> dict[str, int]:
    g: RGLRUCfg = cfg.rglru  # type: ignore[assignment]
    return {"lru_width": g.lru_width or cfg.d_model}


def make_rglru_defs(cfg: ModelConfig) -> dict:
    g: RGLRUCfg = cfg.rglru  # type: ignore[assignment]
    d = cfg.d_model
    w = rglru_dims(cfg)["lru_width"]
    return {
        "in_gate": pdef((d, "d_model"), (w, "d_ff")),       # GeLU branch
        "in_lin": pdef((d, "d_model"), (w, "d_ff")),        # conv+LRU branch
        "conv_w": pdef((g.conv_width, None), (w, "d_ff"), scale=0.5),
        "conv_b": pdef((w, "d_ff"), init="zeros"),
        "w_a": pdef((w, "d_ff"), (w, "d_ff"), scale=0.02),
        "b_a": pdef((w, "d_ff"), init="zeros", dtype=torch.float32),
        "w_x": pdef((w, "d_ff"), (w, "d_ff"), scale=0.02),
        "b_x": pdef((w, "d_ff"), init="zeros", dtype=torch.float32),
        "lam": pdef((w, "d_ff"), init="ones", dtype=torch.float32),
        "out_proj": pdef((w, "d_ff"), (cfg.d_model, "d_model")),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for a, b of
    shape (B, L, W): an inclusive scan of the pairs (a_t, b_t) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), which is associative.  Each
    pass composes every position with the one ``off`` before it (Hillis-
    Steele), so ceil(log2 L) passes of whole-tensor ops give every h_t.
    Each pass builds new tensors (nothing is updated in place), so
    autograd differentiates the scan."""
    n = a.shape[1]
    off = 1
    while off < n:
        new_b = torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])
        if 2 * off < n:                     # the last pass needs no a
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        b = torch.cat([b[:, :off], new_b], dim=1)
        off *= 2
    return b


def _gates(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a^2) * i * x) in fp32 for post-conv activations x."""
    r = torch.sigmoid(matmul(x, params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid(matmul(x, params["w_x"]).float() + params["b_x"])
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * i * x.float()
    return a, gated


def _rglru_core(params: dict, x: torch.Tensor,
                h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, W) post-conv activations -> (y in x's dtype, h_last fp32)."""
    a, gated = _gates(params, x)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1,
        # and neutralize a_1 so the scan composition stays correct
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.float()[:, None], gated[:, 1:]], dim=1)
        a = torch.cat([torch.ones_like(a[:, :1]), a[:, 1:]], dim=1)
    h = _linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def rglru_block_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      return_state: bool = False):
    gate = _gelu(matmul(x, params["in_gate"]))
    lin = matmul(x, params["in_lin"])
    width = params["conv_w"].shape[0]
    state = torch.zeros((x.shape[0], width - 1, lin.shape[-1]), dtype=lin.dtype,
                        device=x.device)
    xp = torch.cat([state, lin], dim=1)
    conv = sum(xp[:, i:i + lin.shape[1]] * params["conv_w"][i][None, None]
               for i in range(width)) + params["conv_b"][None, None]
    y, h_last = _rglru_core(params, conv)
    out = matmul(y * gate, params["out_proj"])
    if return_state:
        return out, {"conv": lin[:, -(width - 1):], "h": h_last.to(x.dtype)}
    return out


def rglru_block_decode(params: dict, x: torch.Tensor, cache: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """cache: {"conv": (B, W-1, lru_width), "h": (B, lru_width)}.  A leaf
    is updated in place and returned where its dtype holds the step's
    result; where the step widens it (a bf16 leaf under fp32 activations,
    as the reference's step promotes it), the new value is a new tensor."""
    gate = _gelu(matmul(x, params["in_gate"]))                   # (B,1,W)
    lin = matmul(x, params["in_lin"])
    dt = torch.promote_types(cache["conv"].dtype, lin.dtype)
    xp = torch.cat([cache["conv"].to(dt), lin.to(dt)], dim=1)   # (B, W, lru)
    conv = (xp * params["conv_w"][None]).sum(dim=1, keepdim=True) \
        + params["conv_b"][None, None]
    xt = conv[:, 0]                                              # (B, W)
    a, gated = _gates(params, xt)
    h = (a * cache["h"].float() + gated).to(x.dtype)
    y = matmul(h[:, None] * gate, params["out_proj"])
    new = {"conv": xp[:, 1:], "h": h}
    for name, val in new.items():
        if val.dtype == cache[name].dtype:
            new[name] = cache[name].copy_(val)
    return y, new
