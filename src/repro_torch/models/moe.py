"""Mixture-of-Experts FFN: shared + routed experts, top-k routing.

Ports ``src/repro/models/moe.py``.  Two dispatch implementations
(selected by ``MoECfg.dispatch``), both returning ``(y, aux)`` where
``aux`` carries the load-balancing loss:

* ``gshard``  — einsum one-hot dispatch/combine.  Exact and simple but
  O(T·E·C·d) FLOPs: the correctness oracle at smoke scale.
* ``scatter`` — capacity-bounded scatter of each (token, expert)
  assignment into an (E, C, d) buffer, the expert SwiGLUs as batched
  matrix products, and a gather back.  Assignments past an expert's
  capacity are dropped, as in the reference.

``shard_map`` is the reference's expert-parallel dispatch (two
``all_to_all``s over the model axis).  Without a mesh the reference runs
``scatter``; the port runs ``scatter`` when no ``torch.distributed``
process group of more than one rank is initialized, and raises under
one (ROADMAP.md, Queue 1 item 7).

MoE dispatch is PyTorch ops on every device: the reference computes it
in jnp outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoECfg
from repro_torch.models.layers import swiglu
from repro_torch.models.spec import pdef


def make_moe_defs(cfg: ModelConfig) -> dict:
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    d = cfg.d_model
    defs: dict = {
        "router": pdef((d, "d_model"), (m.n_experts, None), dtype=torch.float32),
        "experts": {
            "w1": pdef((m.n_experts, "experts"), (d, "d_model"), (m.d_ff_expert, "d_ff")),
            "w3": pdef((m.n_experts, "experts"), (d, "d_model"), (m.d_ff_expert, "d_ff")),
            "w2": pdef((m.n_experts, "experts"), (m.d_ff_expert, "d_ff"), (d, "d_model")),
        },
    }
    if m.n_shared:
        defs["shared"] = {
            "w1": pdef((d, "d_model"), (m.shared_ff, "d_ff")),
            "w3": pdef((d, "d_model"), (m.shared_ff, "d_ff")),
            "w2": pdef((m.shared_ff, "d_ff"), (d, "d_model")),
        }
    return defs


def _route(params: dict, xf: torch.Tensor, m: MoECfg
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (T, d) -> (weights (T,k), idx (T,k), aux_loss scalar)."""
    logits = xf.float() @ params["router"].float()                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)                   # (T, k), descending
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    me = probs.mean(0)                                            # (E,)
    ce = torch.bincount(idx.reshape(-1), minlength=m.n_experts).float() / idx.numel()
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight
    return w.to(xf.dtype), idx, aux


def _expert_ffn(experts: dict, h_in: torch.Tensor) -> torch.Tensor:
    """h_in: (E, C, d) -> (E, C, d); per-expert SwiGLU (batched over E)."""
    return swiglu(experts, h_in)


def _capacity(m: MoECfg, t: int) -> int:
    c = int(m.capacity_factor * t * m.top_k / m.n_experts)
    return max(8, min(t, -(-c // 8) * 8))  # round up to 8, clamp


def moe_gshard(params: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Einsum one-hot dispatch (exact oracle, small scale)."""
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    w, idx, aux = _route(params, xf, m)
    cap = _capacity(m, t)
    onehot = F.one_hot(idx, m.n_experts)                          # (T,k,E) int64
    per_t = onehot.sum(1)                                         # (T,E)
    pos = torch.cumsum(per_t, 0) - per_t                          # slots before t
    pos_k = pos[:, None, :] + torch.cumsum(onehot, 1) - onehot    # (T,k,E)
    in_cap = (pos_k < cap) & (onehot > 0)
    pos_oh = F.one_hot(torch.where(in_cap, pos_k, cap), cap + 1)[..., :cap].to(xf.dtype)
    dispatch = (pos_oh * in_cap[..., None]).sum(1)                # (T,E,C)
    combine = (pos_oh * (w[..., None, None] * in_cap[..., None])).sum(1)
    h_in = torch.einsum("tec,td->ecd", dispatch, xf)
    h_out = _expert_ffn(params["experts"], h_in)
    dt = torch.promote_types(combine.dtype, h_out.dtype)
    y = torch.einsum("tec,ecd->td", combine.to(dt), h_out.to(dt))
    if m.n_shared:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(b, s, d), aux


def _positions_hierarchical(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each assignment within its expert, in flat order: a
    cumsum within chunks plus an exclusive cumsum of the per-chunk counts,
    as the reference computes it (the result equals one global cumsum)."""
    tk = e_flat.shape[0]
    n_chunks = 1
    for cand in (64, 32, 16, 8, 4, 2):
        if tk % cand == 0:
            n_chunks = cand
            break
    ec = e_flat.reshape(n_chunks, tk // n_chunks)
    oh = F.one_hot(ec, n_experts)                                 # (C, L, E)
    local = torch.cumsum(oh, 1) - oh                              # within chunk
    counts = oh.sum(1)                                            # (C, E)
    offsets = torch.cumsum(counts, 0) - counts                    # exclusive
    pos = torch.gather(local + offsets[:, None, :], 2, ec[..., None])[..., 0]
    return pos.reshape(tk)


def moe_scatter(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather dispatch.  The reference adds every assignment into
    its (expert, slot) with the dropped ones zeroed and sent to slot (0, 0);
    here each kept assignment is copied into its own row of a flat
    (E·C + 1, d) buffer and every dropped one into the spare last row, which
    is cut off: the same buffer, no accumulation, no host sync."""
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    w, idx, aux = _route(params, xf, m)
    cap = _capacity(m, t)
    n_slots = m.n_experts * cap

    e_flat = idx.reshape(-1)                                      # (T*k,)
    pos_flat = _positions_hierarchical(e_flat, m.n_experts)
    keep = pos_flat < cap
    slot = torch.where(keep, e_flat * cap + pos_flat, n_slots)   # spare row when dropped

    x_rep = xf.repeat_interleave(m.top_k, dim=0)                  # (T*k, d)
    buf = xf.new_zeros((n_slots + 1, d))
    buf.index_copy_(0, slot, x_rep)
    h_out = _expert_ffn(params["experts"], buf[:n_slots].view(m.n_experts, cap, d))

    gathered = h_out.reshape(n_slots, d)[torch.where(keep, slot, 0)]   # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, 0)
    y = (gathered.reshape(t, m.top_k, d) * w[..., None].to(gathered.dtype)).sum(1)
    if m.n_shared:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(b, s, d), aux


def moe_shard_map(params: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch.  On one process it is ``moe_scatter``, as
    the reference's is without a mesh; under a process group of more than
    one rank it raises rather than run every expert on each rank."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "expert-parallel MoE (all_to_all over ranks) is not ported yet: "
            "ROADMAP.md, Queue 1 item 7")
    return moe_scatter(params, x, cfg)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    if m.dispatch == "gshard":
        return moe_gshard(params, x, cfg)
    if m.dispatch == "shard_map":
        return moe_shard_map(params, x, cfg)
    return moe_scatter(params, x, cfg)
