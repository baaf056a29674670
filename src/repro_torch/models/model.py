"""Model assembly, the ``("attn", "dense")`` and ``("ssd", "none")`` block
kinds: TransformerLM over per-layer block kinds.

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
* ``decode_step(params, state, batch, cfg)`` — one-token serve step

``forward_train`` and ``loss_fn`` differentiate with torch autograd:
where the reference wraps each layer (and each CE chunk) in
``jax.checkpoint``, ``remat`` wraps it in ``torch.utils.checkpoint``.
Prefill and decode run under ``torch.no_grad``.

Attention blocks run the Hopper flash kernel on CUDA, in both directions
under autograd; SSD blocks the Hopper SSD scan kernel, forward only.
Other mixers and ffns raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import ssm
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (
    attention_decode,
    attention_train,
    make_attention_defs,
    make_ffn_defs,
    make_norm_def,
    rms_norm,
    swiglu,
)
from repro_torch.models.spec import pdef, stack_defs, tree_leaves, tree_map


def _not_ported(what: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} {name!r} is not ported yet: ROADMAP.md, 'Next slices' item 4")


def _check_supported(cfg: ModelConfig) -> None:
    cfg.validate()
    for mixer, ffn in cfg.block_kinds():
        if mixer not in ("attn", "ssd"):
            raise _not_ported("mixer", mixer)
        if ffn not in ("dense", "none"):
            raise _not_ported("ffn", ffn)
    if cfg.encoder_layers:
        raise _not_ported("encoder-decoder", cfg.name)
    if cfg.input_kind != "tokens":
        raise _not_ported("input kind", cfg.input_kind)
    if cfg.mtp:
        raise _not_ported("multi-token prediction", cfg.name)


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


def block_defs(cfg: ModelConfig, kind: BlockKind) -> dict:
    mixer, ffn = kind
    d: dict[str, Any] = {"ln1": make_norm_def(cfg.d_model)}
    if mixer == "attn":
        d["attn"] = make_attention_defs(cfg)
    else:
        d["ssd"] = ssm.make_ssd_defs(cfg)
    if ffn == "dense":
        d["ln2"] = make_norm_def(cfg.d_model)
        d["ffn"] = make_ffn_defs(cfg.d_model, cfg.d_ff)
    return d


def _apply_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
               kind: BlockKind) -> torch.Tensor:
    if kind[1] == "none":
        return x
    return x + swiglu(params["ffn"], rms_norm(x, params["ln2"], cfg.norm_eps))


def block_train(params: dict, x: torch.Tensor, cfg: ModelConfig,
                kind: BlockKind) -> torch.Tensor:
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind[0] == "attn":
        y = attention_train(params["attn"], h, cfg)
    else:
        y = ssm.ssd_block_train(params["ssd"], h, cfg)
    return _apply_ffn(params, x + y, cfg, kind)


def block_decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 kind: BlockKind) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind[0] == "attn":
        y, c = attention_decode(params["attn"], h, cache["attn"], cfg)
        new_cache = {**cache, "attn": c}
    else:
        y, c = ssm.ssd_block_decode(params["ssd"], h, cache["ssd"], cfg)
        new_cache = {**cache, "ssd": c}
    return _apply_ffn(params, x + y, cfg, kind), new_cache


def block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  kind: BlockKind) -> tuple[torch.Tensor, dict]:
    """Like block_train but also captures the decode cache (prefill path)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind[0] == "attn":
        y, kvs = attention_train(params["attn"], h, cfg, return_kv=True)
        entry = {"attn": {**kvs, "len": torch.tensor(x.shape[1], dtype=torch.int32,
                                                     device=x.device)}}
    else:
        y, c = ssm.ssd_block_train(params["ssd"], h, cfg, return_state=True)
        entry = {"ssd": c}
    return _apply_ffn(params, x + y, cfg, kind), entry


# ---------------------------------------------------------------------------
# cache parameter trees (decode state)
# ---------------------------------------------------------------------------


def _block_cache_defs(cfg: ModelConfig, kind: BlockKind, batch: int,
                      seq_len: int) -> dict:
    if kind[0] == "ssd":
        s = cfg.ssm
        dims = ssm.ssm_dims(cfg)
        return {"ssd": {
            "conv": pdef((batch, "batch"), (s.conv_width - 1, None),
                         (dims["conv_dim"], "heads"), init="zeros"),
            "state": pdef((batch, "batch"), (dims["n_heads"], "heads"),
                          (s.head_dim, None), (s.d_state, None), init="zeros"),
        }}
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"attn": {
        "k": pdef((batch, "batch"), (seq_len, "seq"), (kv, "kv_heads"), (hd, None),
                  init="zeros"),
        "v": pdef((batch, "batch"), (seq_len, "seq"), (kv, "kv_heads"), (hd, None),
                  init="zeros"),
        "len": pdef(init="zeros", dtype=torch.int32),
    }}


# ---------------------------------------------------------------------------
# whole-model parameter trees
# ---------------------------------------------------------------------------


def param_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    defs: dict[str, Any] = {
        "embed": pdef((cfg.vocab_size, "vocab"), (cfg.d_model, "d_model"),
                      scale=1.0),
        "final_norm": make_norm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = pdef((cfg.d_model, "d_model"), (cfg.vocab_size, "vocab"))
    defs["segments"] = [
        {str(u): stack_defs(block_defs(cfg, kind), repeats) for u, kind in enumerate(unit)}
        for unit, repeats in cfg.scan_segments()
    ]
    return defs


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-state tree matching the segment structure."""
    _check_supported(cfg)
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
    return F.embedding(batch["inputs"], params["embed"]).to(cfg.cdtype)


def _needs_grad(tree: Any) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(tree))


def _run_unit(layer_params: dict, x: torch.Tensor, cfg: ModelConfig, unit) -> torch.Tensor:
    for u, kind in enumerate(unit):
        x = block_train(layer_params[str(u)], x, cfg, kind)
    return x


def forward_train(params: dict, batch: dict, cfg: ModelConfig, *, remat: bool = True
                  ) -> tuple[torch.Tensor, None, torch.Tensor]:
    """Returns (hidden (B,S,d) after the final norm, enc_out (None: no
    encoder in this slice), aux_loss (0: no MoE in this slice)).  Under
    autograd with ``remat`` each layer keeps only its input and recomputes
    the rest in the backward."""
    grad = _needs_grad(params)
    x = embed_inputs(params, batch, cfg)
    for seg_params, (unit, repeats) in zip(params["segments"], cfg.scan_segments()):
        for layer_params in _unbind_layers(seg_params, repeats):
            if grad and remat:
                x = checkpoint(_run_unit, layer_params, x, cfg, unit, use_reentrant=False)
            else:
                x = _run_unit(layer_params, x, cfg, unit)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, None, torch.zeros((), dtype=torch.float32, device=x.device)


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
    loss) and its metrics ``ce_loss`` and ``aux_loss``.  The CE runs in
    sequence chunks of ``ce_chunk`` when they divide the sequence, so the
    (B, S, vocab) logits are never held at once; under ``remat`` each
    chunk's logits are recomputed in the backward."""
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
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


@torch.no_grad()
def prefill_forward(params: dict, batch: dict, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill: returns (last-token logits, decode cache)."""
    x = embed_inputs(params, batch, cfg)
    segments_cache = []
    for seg_params, (unit, repeats) in zip(params["segments"], cfg.scan_segments()):
        entries = []
        for i in range(repeats):
            layer_params = _layer(seg_params, i)
            entry = {}
            for u, kind in enumerate(unit):
                x, entry[str(u)] = block_prefill(layer_params[str(u)], x, cfg, kind)
            entries.append(entry)
        segments_cache.append(_stack_leaves(entries))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1:], cfg)
    return logits, {"segments": segments_cache}


@torch.no_grad()
def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  batch: {"inputs": (B,1) ids}.  Returns (logits,
    state); the state's caches are updated in place (see :func:`_widen`)."""
    x = embed_inputs(params, batch, cfg)
    for seg_params, seg_cache, (unit, repeats) in zip(
            params["segments"], state["segments"], cfg.scan_segments()):
        for i in range(repeats):
            layer_params, layer_cache = _layer(seg_params, i), _layer(seg_cache, i)
            for u, kind in enumerate(unit):
                x, new = block_decode(layer_params[str(u)], x, layer_cache[str(u)], cfg, kind)
                _widen(seg_cache[str(u)], i, new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), state
