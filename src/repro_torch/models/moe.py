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

``shard_map`` is the reference's expert-parallel dispatch: under an
activation-sharding context whose mesh has a ``model`` axis, each model
rank routes its slice of the tokens and two ``all_to_all``s over the
``model`` group carry them to the experts' owners and back
(:func:`moe_shard_map`, run on each rank's shards through DTensor's
``local_map``).  Without a mesh context it is ``scatter``, as in the
reference.

MoE dispatch is PyTorch ops on every device: the reference computes it
in jnp outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoECfg
from repro_torch.models.layers import (
    constrain,
    current_mesh,
    gather_fsdp,
    is_dtensor,
    swiglu,
    to_layout,
)
from repro_torch.models.spec import pdef

#: logical axes of the (E, C, d) expert buffers and of their hidden (E, C, d_ff)
EXPERT_AXES = ("experts", None, "d_model")
EXPERT_FF_AXES = ("experts", None, "d_ff")


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
    logits = xf.float() @ gather_fsdp(params["router"], xf).float()   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)                   # (T, k), descending
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w.to(xf.dtype), idx, _aux_loss(probs, idx, m)


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, m: MoECfg) -> torch.Tensor:
    """Switch-style load balance: E * sum(mean prob * share of assignments).
    The shares are counted into a fixed (E,) buffer, whose size does not
    depend on the data (a ``meta`` tensor has none)."""
    me = probs.mean(0)                                            # (E,)
    flat = idx.reshape(-1)
    ce = probs.new_zeros(m.n_experts).index_add_(
        0, flat, torch.ones_like(flat, dtype=probs.dtype)) / flat.numel()
    return m.n_experts * torch.sum(me * ce) * m.router_aux_weight


def _expert_ffn(experts: dict, h_in: torch.Tensor) -> torch.Tensor:
    """h_in: (E, C, d) -> (E, C, d); per-expert SwiGLU (batched over E)."""
    return swiglu(experts, h_in, EXPERT_FF_AXES)


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
    is cut off: the same buffer, no accumulation, no host sync.

    Under a mesh (DTensor tokens) the routing and the dispatch run on every
    rank over all the tokens (few: a decode step's, the one case that
    comes here under a mesh) as plain tensors, and the experts' SwiGLUs as
    DTensors over the experts' shards; the buffer is all-gathered back."""
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    b, s, d = x.shape
    if not is_dtensor(x):
        y, aux = _scatter(params["router"], x.reshape(b * s, d), m,
                          lambda buf: _expert_ffn(params["experts"], buf))
        if m.n_shared:
            y = y + swiglu(params["shared"], x.reshape(b * s, d))
        return y.reshape(b, s, d), aux
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    xf = to_layout(x, whole).reshape(b * s, d)

    def experts(buf: torch.Tensor) -> torch.Tensor:
        buf = constrain(DTensor.from_local(buf, mesh, whole, run_check=False), EXPERT_AXES)
        h_out = constrain(_expert_ffn(params["experts"], buf), EXPERT_AXES)
        return to_layout(h_out, whole).to_local()

    y, aux = _scatter(to_layout(params["router"], whole).to_local(), xf.to_local(), m,
                      experts)
    y, aux = (DTensor.from_local(t, mesh, whole, run_check=False) for t in (y, aux))
    if m.n_shared:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(b, s, d), aux


def _scatter(router: torch.Tensor, xf: torch.Tensor, m: MoECfg, experts
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_scatter`'s routed part on (T, d) tokens: (y, aux), the
    experts applied to the (E, C, d) buffer by ``experts``."""
    t, d = xf.shape
    w, idx, aux = _route({"router": router}, xf, m)
    cap = _capacity(m, t)
    n_slots = m.n_experts * cap

    e_flat = idx.reshape(-1)                                      # (T*k,)
    pos_flat = _positions_hierarchical(e_flat, m.n_experts)
    keep = pos_flat < cap
    slot = torch.where(keep, e_flat * cap + pos_flat, n_slots)   # spare row when dropped

    x_rep = xf.repeat_interleave(m.top_k, dim=0)                  # (T*k, d)
    buf = xf.new_zeros((n_slots + 1, d))
    buf.index_copy_(0, slot, x_rep)
    h_out = experts(buf[:n_slots].view(m.n_experts, cap, d))

    gathered = h_out.reshape(n_slots, d)[torch.where(keep, slot, 0)]   # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, 0)
    y = (gathered.reshape(t, m.top_k, d) * w[..., None].to(gathered.dtype)).sum(1)
    return y, aux


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` into a tensor that every rank
    then uses whole (replicated).  Its gradient is the same on every rank,
    so the backward takes this rank's block of it; the functional
    collective's own backward would sum the copies (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim: int, group, index: int):
        import torch.distributed._functional_collectives as funcol

        ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
        out = funcol.all_gather_tensor(t, dim, group)
        return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def moe_shard_map(params: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit all-to-all (the reference's
    ``shard_map``, here ``local_map`` over the context's mesh).

    An automatically partitioned scatter/gather materialises the full
    (E, C, d) buffer on every device and all-reduces it.  Here the tokens
    travel with two ``all_to_all``s over the ``model`` (expert) group:

      local dispatch (scatter into the per-SENDER capacity buffer)
      -> all_to_all -> local expert FFN -> all_to_all back
      -> local combine -> all_gather over the model group.

    Collective bytes drop from O(E·C_global·d · n_dev) to O(T·k·cf·d).
    The collectives are the autograd-aware functional ones, so the
    gradient runs the same exchanges backwards; the gradients of the
    tokens and the router leave as partial sums over the ranks whose
    slices used them.  Falls back to
    ``moe_scatter`` without a mesh context (or on plain tensors), without
    a ``model`` axis, when E does not divide over it, and when the tokens
    of a data shard do not divide over it (decode: one token a sequence).
    """
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    if mesh is None or not is_dtensor(x) or "model" not in mesh.mesh_dim_names:
        return moe_scatter(params, x, cfg)
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, tuple(mesh.shape)))
    n_model = sizes["model"]
    if m.n_experts % n_model:
        return moe_scatter(params, x, cfg)
    data_dims = [i for i, a in enumerate(names) if a != "model"]
    b, s, d = x.shape
    n_data = math.prod(sizes[names[i]] for i in data_dims)
    # token slices must divide over the model axis per data shard; decode
    # steps (one token per sequence) fall back to the scatter dispatch
    if b % n_data or (b // n_data) * s % n_model:
        return moe_scatter(params, x, cfg)
    e_loc = m.n_experts // n_model
    j = mesh.get_local_rank("model")
    # expert weights enter in their FSDP layout (d_model sharded over the
    # data axes) and are all-gathered inside; the gather's backward is a
    # reduce-scatter, so weight grads leave as reduce-scatters
    fsdp_ok = n_data > 1 and d % n_data == 0
    model_group = mesh["model"]

    def layout(model: Any, data: Any) -> list:
        return [model if a == "model" else data for a in names]

    xpl = layout(Replicate(), Shard(0))
    e12 = layout(Shard(0), Shard(1) if fsdp_ok else Replicate())   # w1/w3: (E, d, ff)
    e21 = layout(Shard(0), Shard(2) if fsdp_ok else Replicate())   # w2:    (E, ff, d)
    rep = layout(Replicate(), Replicate())
    # each model rank routes only its slice of the tokens: the gradient of
    # the tokens is a sum over model ranks, the router's over every rank
    x_grad = layout(Partial(), Shard(0))
    router_grad = layout(Partial(), Partial())

    def gather_data(w: torch.Tensor, dim: int) -> torch.Tensor:
        # innermost mesh dim first: a dim sharded over (pod, data) holds
        # data's blocks inside each pod's
        for i in reversed(data_dims):
            w = funcol.all_gather_tensor_autograd(w, dim, mesh[names[i]])
        return w

    def local_moe(xb, router_w, w1, w3, w2):
        # xb: (B_loc, S, d), this data shard's tokens, replicated over
        # 'model'.  Each model rank dispatches its own 1/M token slice, so
        # the expert FFNs see distinct rows from every peer; outputs are
        # reassembled with an all_gather.
        if fsdp_ok:
            w1, w3, w2 = gather_data(w1, 1), gather_data(w3, 1), gather_data(w2, 2)
        bl, sl, dl = xb.shape
        ts = bl * sl // n_model
        xf = xb.reshape(bl * sl, dl)[j * ts:(j + 1) * ts]          # (Ts, d)
        probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
        wgt, idx = torch.topk(probs, m.top_k, dim=-1)
        wgt = (wgt / torch.clamp(wgt.sum(-1, keepdim=True), min=1e-9)).to(xb.dtype)
        aux = _GatherReplicated.apply(_aux_loss(probs, idx, m)[None], 0, model_group,
                                      j).mean()

        cap = _capacity(m, ts)                                     # per sender
        n_slots = m.n_experts * cap
        e_flat = idx.reshape(-1)                                   # (Ts*k,)
        oh = F.one_hot(e_flat, m.n_experts)
        pos = torch.gather(torch.cumsum(oh, 0) - oh, 1, e_flat[:, None])[:, 0]
        keep = pos < cap
        slot = torch.where(keep, e_flat * cap + pos, n_slots)     # spare row when dropped
        send = xf.new_zeros((n_slots + 1, dl))
        send.index_copy_(0, slot, xf.repeat_interleave(m.top_k, dim=0))   # local scatter

        # route to expert owners: split E across 'model', gather senders
        recv = funcol.all_to_all_single_autograd(send[:n_slots], None, None, model_group)
        h_in = recv.view(n_model, e_loc, cap, dl).transpose(0, 1).reshape(
            e_loc, n_model * cap, dl)
        h_out = swiglu({"w1": w1, "w3": w3, "w2": w2}, h_in, EXPERT_FF_AXES)
        back = h_out.view(e_loc, n_model, cap, dl).transpose(0, 1).reshape(n_slots, dl)
        mine = funcol.all_to_all_single_autograd(back, None, None, model_group)

        gathered = mine[torch.where(keep, slot, 0)]                # (Ts*k, d)
        gathered = torch.where(keep[:, None], gathered, 0)
        y = (gathered.view(ts, m.top_k, dl) * wgt[..., None].to(gathered.dtype)).sum(1)
        # reassemble the full token set from the M slices
        y = _GatherReplicated.apply(y, 0, model_group, j)          # (T, d)
        return y.view(bl, sl, dl), aux

    ex = params["experts"]
    args = (to_layout(x, xpl), to_layout(params["router"], rep), to_layout(ex["w1"], e12),
            to_layout(ex["w3"], e12), to_layout(ex["w2"], e21))
    y, aux = local_map(local_moe, out_placements=(xpl, rep),
                       in_placements=(xpl, rep, e12, e12, e21),
                       in_grad_placements=(x_grad, router_grad, e12, e12, e21),
                       device_mesh=mesh)(*args)
    if m.n_shared:
        y = y + swiglu(params["shared"], x.reshape(b * s, d)).reshape(b, s, d)
    return y, aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    m: MoECfg = cfg.moe  # type: ignore[assignment]
    if m.dispatch == "gshard":
        return moe_gshard(params, x, cfg)
    if m.dispatch == "shard_map":
        return moe_shard_map(params, x, cfg)
    return moe_scatter(params, x, cfg)
