"""Model assembly: TransformerLM over per-layer block kinds, every mixer
(``attn``, ``swa``, ``mla``, ``ssd``, ``rglru``) with ``dense``, ``moe``
or no FFN, token or embedding inputs, the encoder-decoder backbone and
multi-token prediction.

Ports ``src/repro/models/model.py``.  Layers keep the reference's scan
*segments* (``ModelConfig.scan_segments``): each segment stacks its
parameters along a leading axis, and where the reference runs
``lax.scan`` over that axis the port runs a Python loop that indexes the
stacked tensors.  Within a segment the (mixer, ffn) unit is applied
position by position.

Public API (functions bound to a ModelConfig):

* ``param_defs(cfg)``                        — ParamDef tree
* ``forward_train(params, batch, cfg)``      — final hidden states
* ``loss_fn(params, batch, cfg)``            — scalar fp32 loss (chunked CE)
* ``cache_defs(cfg, batch, seq_len)``        — decode-state ParamDef tree
* ``prefill_forward(params, batch, cfg)``    — last-token logits + cache
* ``prefill_cross_memory(params, cache, enc_out, cfg)`` — enc-dec cache fill
* ``decode_step(params, state, batch, cfg)`` — one-token serve step

``forward_train`` and ``loss_fn`` differentiate with torch autograd:
where the reference wraps each layer (and each CE chunk) in
``jax.checkpoint``, ``remat`` wraps it in ``torch.utils.checkpoint``.
Prefill and decode run under ``torch.no_grad``.

Attention blocks run the Hopper flash kernel on CUDA, in both directions
under autograd: causal self-attention, sliding-window self-attention
(``swa``, whose decode cache is a ring buffer one window wide), the
encoder's bidirectional self-attention and the decoder's cross-attention
over the encoder output (``encoder_layers`` > 0; the encoder reads
``batch["enc_embeds"]``), and MLA's prefill at q/k dim 192 over v dim
128 (its decode is the absorbed form over the latent cache, PyTorch
ops).  SSD blocks run the Hopper SSD scan kernel, forward only; RG-LRU
blocks (``models/griffin.py``) and MoE FFNs (``models/moe.py``) are
PyTorch ops.  An ``input_kind="embeds"`` model (llava) reads
``batch["embeds"]`` (B, S, d); its decode takes {"embeds": (B, 1, d)} or
falls back to token ids through the table, as the serve plane sends.
With ``cfg.mtp`` (deepseek-v3) the parameter tree carries the
multi-token-prediction block and ``loss_fn`` adds its loss; serving does
not run it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import griffin, ssm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (
    attention_decode,
    attention_train,
    make_attention_defs,
    make_ffn_defs,
    make_mla_defs,
    make_norm_def,
    matmul,
    mla_decode,
    mla_train,
    rms_norm,
    swiglu,
)
from repro_torch.models.spec import pdef, stack_defs, tree_leaves, tree_map


ENCODER_KIND: BlockKind = ("bidir", "dense")


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def _unbind_layers(tree: Any, n: int) -> list:
    """The ``n`` layers of a stacked tree as views from one ``unbind`` a
    leaf, so autograd stacks each leaf's gradient once rather than adding
    a full-size zero tensor a layer."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[i], parts, is_leaf=lambda p: isinstance(p, tuple))
            for i in range(n)]


def _stack_leaves(trees: list) -> Any:
    """Inverse of :func:`_layer`: stack per-layer trees on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _widen(stacked: dict, i: int, new: dict) -> None:
    """Store the cache leaves a block's step widened, and only those.

    Blocks update their cache leaves in place.  Where a step returns a
    leaf of another dtype (a bf16 SSD state under fp32 activations: the
    reference's step promotes it), the stacked leaf is recast once and
    layer ``i``'s value stored; later layers then update in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            _widen(stacked[k], i, v)
        elif v.dtype != stacked[k].dtype:
            stacked[k] = stacked[k].to(v.dtype)
            stacked[k][i].copy_(v)


# ---------------------------------------------------------------------------
# per-block parameter trees
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, kind: BlockKind, *, cross: bool = False) -> dict:
    mixer, ffn = kind
    d: dict[str, Any] = {"ln1": make_norm_def(cfg.d_model)}
    if mixer in ("attn", "swa", "bidir"):
        d["attn"] = make_attention_defs(cfg)
    elif mixer == "mla":
        d["attn"] = make_mla_defs(cfg)
    elif mixer == "ssd":
        d["ssd"] = ssm.make_ssd_defs(cfg)
    else:
        d["rglru"] = griffin.make_rglru_defs(cfg)
    if cross:
        d["ln_x"] = make_norm_def(cfg.d_model)
        d["cross"] = make_attention_defs(cfg, cross=True)
    if ffn == "dense":
        d["ln2"] = make_norm_def(cfg.d_model)
        d["ffn"] = make_ffn_defs(cfg.d_model, cfg.d_ff)
    elif ffn == "moe":
        d["ln2"] = make_norm_def(cfg.d_model)
        d["moe"] = moe_mod.make_moe_defs(cfg)
    return d


def _apply_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
               kind: BlockKind) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + ffn(x), the MoE aux loss or 0)."""
    ffn = kind[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if ffn == "dense":
        y = swiglu(params["ffn"], h)
    else:
        y, aux = moe_mod.moe_ffn(params["moe"], h, cfg)
    return x + y, aux


def _cross(params: dict, x: torch.Tensor, cfg: ModelConfig, enc_out: torch.Tensor | None
           ) -> tuple[torch.Tensor, dict | None]:
    """x plus the cross-attention over ``enc_out`` where the block has one,
    and that attention's K/V for the cache (None where it has none)."""
    if enc_out is None or "cross" not in params:
        return x, None
    h = rms_norm(x, params["ln_x"], cfg.norm_eps)
    out, kvs = attention_train(params["cross"], h, cfg, kv_source=enc_out, return_kv=True)
    return x + out, kvs


def block_train(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: BlockKind, *,
                enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(x after the block, the MoE aux loss or 0).  The ``bidir`` mixer is
    the encoder's unmasked self-attention."""
    mixer = kind[0]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if mixer in ("attn", "bidir"):
        y = attention_train(params["attn"], h, cfg, bidirectional=mixer == "bidir")
    elif mixer == "swa":
        y = attention_train(params["attn"], h, cfg, window=cfg.window)
    elif mixer == "mla":
        y = mla_train(params["attn"], h, cfg)
    elif mixer == "ssd":
        y = ssm.ssd_block_train(params["ssd"], h, cfg)
    else:
        y = griffin.rglru_block_train(params["rglru"], h, cfg)
    x, _ = _cross(params, x + y, cfg, enc_out)
    return _apply_ffn(params, x, cfg, kind)


def block_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 kind: BlockKind, *, cross_memory: dict | None = None
                 ) -> tuple[torch.Tensor, dict]:
    mixer = kind[0]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):     # a window is the width of the swa ring buffer
        y, c = attention_decode(params["attn"], h, cache["attn"], cfg)
        new_cache = {**cache, "attn": c}
    elif mixer == "mla":
        y, c = mla_decode(params["attn"], h, cache["attn"], cfg)
        new_cache = {**cache, "attn": c}
    elif mixer == "ssd":
        y, c = ssm.ssd_block_decode(params["ssd"], h, cache["ssd"], cfg)
        new_cache = {**cache, "ssd": c}
    else:
        y, c = griffin.rglru_block_decode(params["rglru"], h, cache["rglru"], cfg)
        new_cache = {**cache, "rglru": c}
    x = x + y
    mem = cross_memory if cross_memory is not None else cache.get("cross")
    if mem is not None and "cross" in params:
        h = rms_norm(x, params["ln_x"], cfg.norm_eps)
        y, _ = attention_decode(params["cross"], h, {}, cfg, cross_memory=mem)
        x = x + y
    return _apply_ffn(params, x, cfg, kind)[0], new_cache


def block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: BlockKind, *,
                  enc_out: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Like block_train but also captures the decode cache (prefill path).
    A sliding-window layer keeps the last ``w = min(window, S)`` keys in
    the ring-buffer layout, token p at slot p % w; an MLA layer keeps its
    latent ``ckv`` and roped ``k_rope``."""
    mixer, s = kind[0], x.shape[1]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    length = torch.tensor(s, dtype=torch.int32, device=x.device)
    if mixer in ("attn", "swa"):
        window = cfg.window if mixer == "swa" else 0
        y, kvs = attention_train(params["attn"], h, cfg, window=window, return_kv=True)
        if window and s > window:
            kvs = {k: torch.roll(v[:, -window:], s % window, dims=1) for k, v in kvs.items()}
        entry = {"attn": {**kvs, "len": length}}
    elif mixer == "mla":
        y, c = mla_train(params["attn"], h, cfg, return_cache=True)
        entry = {"attn": {**c, "len": length}}
    elif mixer == "ssd":
        y, c = ssm.ssd_block_train(params["ssd"], h, cfg, return_state=True)
        entry = {"ssd": c}
    else:
        y, c = griffin.rglru_block_train(params["rglru"], h, cfg, return_state=True)
        entry = {"rglru": c}
    x, cross_kv = _cross(params, x + y, cfg, enc_out)
    if cross_kv is not None:
        entry["cross"] = cross_kv
    return _apply_ffn(params, x, cfg, kind)[0], entry


# ---------------------------------------------------------------------------
# cache parameter trees (decode state)
# ---------------------------------------------------------------------------


def _block_cache_defs(cfg: ModelConfig, kind: BlockKind, batch: int,
                      seq_len: int) -> dict:
    mixer = kind[0]
    if mixer == "rglru":
        w = griffin.rglru_dims(cfg)["lru_width"]
        return {"rglru": {
            "conv": pdef((batch, "batch"), (cfg.rglru.conv_width - 1, None), (w, "d_ff"),
                         init="zeros"),
            "h": pdef((batch, "batch"), (w, "d_ff"), init="zeros"),
        }}
    if mixer == "mla":   # the compressed latent and the shared roped key: no ring buffer
        m = cfg.mla
        return {"attn": {
            "ckv": pdef((batch, "batch"), (seq_len, "seq"), (m.kv_lora_rank, None),
                        init="zeros"),
            "k_rope": pdef((batch, "batch"), (seq_len, "seq"), (m.qk_rope_head_dim, None),
                           init="zeros"),
            "len": pdef(init="zeros", dtype=torch.int32),
        }}
    if mixer == "ssd":
        s = cfg.ssm
        dims = ssm.ssm_dims(cfg)
        return {"ssd": {
            "conv": pdef((batch, "batch"), (s.conv_width - 1, None),
                         (dims["conv_dim"], "heads"), init="zeros"),
            "state": pdef((batch, "batch"), (dims["n_heads"], "heads"),
                          (s.head_dim, None), (s.d_state, None), init="zeros"),
        }}
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads

    def kv_defs(smax: int, axis: str | None) -> dict:
        return {name: pdef((batch, "batch"), (smax, axis), (kv, "kv_heads"), (hd, None),
                           init="zeros") for name in ("k", "v")}

    # a sliding-window layer's ring buffer is one window wide
    kvs = kv_defs(min(cfg.window, seq_len), None) if mixer == "swa" else kv_defs(seq_len, "seq")
    entry = {"attn": {**kvs, "len": pdef(init="zeros", dtype=torch.int32)}}
    if cfg.encoder_layers:
        # enc-dec decoder blocks carry a static cross-attention KV memory,
        # filled from the encoder output at prefill time
        entry["cross"] = kv_defs(seq_len, "seq")
    return entry


# ---------------------------------------------------------------------------
# whole-model parameter trees
# ---------------------------------------------------------------------------


def param_defs(cfg: ModelConfig) -> dict:
    cfg.validate()
    cross = cfg.encoder_layers > 0
    defs: dict[str, Any] = {
        "embed": pdef((cfg.vocab_size, "vocab"), (cfg.d_model, "d_model"),
                      scale=1.0),
        "final_norm": make_norm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = pdef((cfg.d_model, "d_model"), (cfg.vocab_size, "vocab"))
    defs["segments"] = [
        {str(u): stack_defs(block_defs(cfg, kind, cross=cross), repeats)
         for u, kind in enumerate(unit)}
        for unit, repeats in cfg.scan_segments()
    ]
    if cross:
        defs["encoder"] = {
            "blocks": stack_defs(block_defs(cfg, ENCODER_KIND), cfg.encoder_layers),
            "final_norm": make_norm_def(cfg.d_model),
        }
    if cfg.mtp:
        defs["mtp"] = {
            "proj": pdef((2 * cfg.d_model, "d_model"), (cfg.d_model, "d_model")),
            "block": block_defs(cfg, _mtp_kind(cfg)),
            "norm_h": make_norm_def(cfg.d_model),
            "norm_e": make_norm_def(cfg.d_model),
        }
    return defs


def _mtp_kind(cfg: ModelConfig) -> BlockKind:
    """The multi-token-prediction block: the pattern's last mixer, dense FFN."""
    return (cfg.pattern[-1][0], "dense")


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-state tree matching the segment structure."""
    cfg.validate()
    return {
        "segments": [
            {str(u): stack_defs(_block_cache_defs(cfg, kind, batch, seq_len), repeats)
             for u, kind in enumerate(unit)}
            for unit, repeats in cfg.scan_segments()
        ],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.input_kind == "embeds":
        return batch["embeds"].to(cfg.cdtype)
    return F.embedding(batch["inputs"], params["embed"]).to(cfg.cdtype)


def _needs_grad(tree: Any) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(tree))


def _run_unit(layer_params: dict, x: torch.Tensor, cfg: ModelConfig, unit,
              enc_out: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u, kind in enumerate(unit):
        x, a = block_train(layer_params[str(u)], x, cfg, kind, enc_out=enc_out)
        aux = aux + a
    return x, aux


def _run_layers(x: torch.Tensor, layers: list, cfg: ModelConfig, unit, *, grad: bool,
                remat: bool, enc_out: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply ``unit`` with each of ``layers``' parameters in turn; under
    autograd with ``remat`` each layer keeps only its input."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_params in layers:
        if grad and remat:
            x, a = checkpoint(_run_unit, layer_params, x, cfg, unit, enc_out,
                              use_reentrant=False)
        else:
            x, a = _run_unit(layer_params, x, cfg, unit, enc_out)
        aux = aux + a
    return x, aux


def _encoder_forward(params: dict, batch: dict, cfg: ModelConfig, *,
                    remat: bool = True) -> torch.Tensor:
    """The encoder stack over ``batch["enc_embeds"]`` (B, Se, d): its
    normed output, the decoder's cross-attention memory."""
    enc = params["encoder"]
    x = batch["enc_embeds"].to(cfg.cdtype)
    layers = _unbind_layers({"0": enc["blocks"]}, cfg.encoder_layers)
    x, _ = _run_layers(x, layers, cfg, (ENCODER_KIND,), grad=_needs_grad(params), remat=remat)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward_train(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Returns (hidden (B,S,d) after the final norm, the encoder output
    (None without an encoder), the summed MoE aux loss (0 without MoE)).
    Under autograd with ``remat`` each layer keeps only its input and
    recomputes the rest in the backward."""
    grad = _needs_grad(params)
    enc_out = _encoder_forward(params, batch, cfg, remat=remat) if cfg.encoder_layers else None
    x = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (unit, repeats) in zip(params["segments"], cfg.scan_segments()):
        x, a = _run_layers(x, _unbind_layers(seg_params, repeats), cfg, unit, grad=grad,
                           remat=remat, enc_out=enc_out)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, enc_out, aux


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()


def _ce_chunk(params: dict, h: torch.Tensor, targets: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy + z-loss for one sequence chunk; returns (sum, count)
    over the positions whose target is >= 0."""
    logits = _logits(params, h, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    # a masked target (-1) reads any logit: its term is multiplied by 0
    gold = torch.gather(logits, -1, targets.clamp(min=0).long()[..., None])[..., 0]
    zloss = 1e-4 * lse ** 2
    valid = (targets >= 0).float()
    return torch.sum((lse - gold + zloss) * valid), torch.sum(valid)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True,
            ce_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Scalar fp32 loss (mean CE + z-loss over targets >= 0, plus the aux
    loss; with ``cfg.mtp`` plus 0.3 times the multi-token-prediction loss)
    and its metrics ``ce_loss``, ``aux_loss`` (and ``mtp_loss``).  The CE
    runs in sequence chunks of ``ce_chunk`` when they divide the sequence,
    so the (B, S, vocab) logits are never held at once; under ``remat``
    each chunk's logits are recomputed in the backward."""
    h, _, aux = forward_train(params, batch, cfg, remat=remat)
    targets = batch["targets"]
    b, s = targets.shape
    if ce_chunk and s > ce_chunk and s % ce_chunk == 0:
        grad = remat and _needs_grad(params)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s, ce_chunk):
            hh, tt = h[:, i:i + ce_chunk], targets[:, i:i + ce_chunk]
            if grad:
                part, c = checkpoint(_ce_chunk, params, hh, tt, cfg, use_reentrant=False)
            else:
                part, c = _ce_chunk(params, hh, tt, cfg)
            tot, cnt = tot + part, cnt + c
    else:
        tot, cnt = _ce_chunk(params, h, targets, cfg)
    loss = tot / torch.clamp(cnt, min=1.0)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if cfg.mtp:
        metrics["mtp_loss"] = _mtp_loss(params, h, batch, cfg)
        loss = loss + 0.3 * metrics["mtp_loss"]
    return loss + aux, metrics


def _mtp_loss(params: dict, h: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: one extra depth predicting t+2.

    h'_t = W [RMSNorm(h_t) ; RMSNorm(Emb(target_{t+1}))] -> block -> head."""
    mtp = params["mtp"]
    targets = batch["targets"]
    # teacher embedding of the next token (targets shifted left by one)
    nxt = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
    e = F.embedding(nxt.clamp(min=0), params["embed"]).to(h.dtype)
    hn = rms_norm(h, mtp["norm_h"], cfg.norm_eps)
    en = rms_norm(e, mtp["norm_e"], cfg.norm_eps)
    hm = matmul(torch.cat([hn, en], dim=-1), mtp["proj"])
    hm, _ = block_train(mtp["block"], hm, cfg, _mtp_kind(cfg))
    # predict t+2: targets shifted by two
    t2 = torch.cat([targets[:, 2:], targets[:, -2:]], dim=1)
    tot, cnt = _ce_chunk(params, hm, t2, cfg)
    return tot / torch.clamp(cnt, min=1.0)


@torch.no_grad()
def prefill_forward(params: dict, batch: dict, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill: returns (last-token logits, decode cache).
    An enc-dec model runs its encoder over ``batch["enc_embeds"]`` and
    stores each decoder layer's cross-attention K/V in the cache."""
    enc_out = _encoder_forward(params, batch, cfg) if cfg.encoder_layers else None
    x = embed_inputs(params, batch, cfg)
    segments_cache = []
    for seg_params, (unit, repeats) in zip(params["segments"], cfg.scan_segments()):
        entries = []
        for i in range(repeats):
            layer_params = _layer(seg_params, i)
            entry = {}
            for u, kind in enumerate(unit):
                x, entry[str(u)] = block_prefill(layer_params[str(u)], x, cfg, kind,
                                                 enc_out=enc_out)
            entries.append(entry)
        segments_cache.append(_stack_leaves(entries))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1:], cfg)
    return logits, {"segments": segments_cache}


@torch.no_grad()
def prefill_cross_memory(params: dict, cache: dict, enc_out: torch.Tensor,
                         cfg: ModelConfig) -> dict:
    """Per-decoder-layer cross-attention K/V from the encoder output, stored
    in (a new tree over) the decode cache: the enc-dec serving prefill.
    The memory's length is the encoder's, whatever the cache's."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    b, s, _ = enc_out.shape
    new_segments = []
    for seg_params, seg_cache, (unit, repeats) in zip(
            params["segments"], cache["segments"], cfg.scan_segments()):
        seg_new = {}
        for u in range(len(unit)):
            entry = dict(seg_cache[str(u)])
            cross_p = seg_params[str(u)].get("cross")
            if cross_p is not None and "cross" in entry:
                entry["cross"] = {
                    name: torch.einsum("bsd,rdf->rbsf", enc_out,
                                       cross_p[w].to(enc_out.dtype))
                    .reshape(repeats, b, s, kv, hd).to(entry["cross"][name].dtype)
                    for name, w in (("k", "wk"), ("v", "wv"))}
            seg_new[str(u)] = entry
        new_segments.append(seg_new)
    return {"segments": new_segments}


@torch.no_grad()
def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  batch: {"inputs": (B,1) ids} or, for an
    ``input_kind="embeds"`` model, {"embeds": (B,1,d)} (ids otherwise, as
    the serve plane sends); optionally {"cross_memory": {"k","v"}} for
    every enc-dec layer (else each layer reads its cache's ``cross``
    entry).  Returns (logits, state); the state's caches are updated in
    place (see :func:`_widen`)."""
    if cfg.input_kind == "embeds" and "embeds" in batch:
        x = batch["embeds"].to(cfg.cdtype)
    else:
        x = F.embedding(batch["inputs"], params["embed"]).to(cfg.cdtype)
    cross_mem = batch.get("cross_memory")
    for seg_params, seg_cache, (unit, repeats) in zip(
            params["segments"], state["segments"], cfg.scan_segments()):
        for i in range(repeats):
            layer_params, layer_cache = _layer(seg_params, i), _layer(seg_cache, i)
            for u, kind in enumerate(unit):
                x, new = block_decode(layer_params[str(u)], x, layer_cache[str(u)], cfg, kind,
                                      cross_memory=cross_mem)
                _widen(seg_cache[str(u)], i, new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), state
