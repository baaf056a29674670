"""Model assembly, ``attn``/``dense`` subset: TransformerLM over per-layer
block kinds.

Ports ``src/repro/models/model.py``.  Layers keep the reference's scan
*segments* (``ModelConfig.scan_segments``): each segment stacks its
parameters along a leading axis, and where the reference runs
``lax.scan`` over that axis the port runs a Python loop that indexes the
stacked tensors.  Within a segment the (mixer, ffn) unit is applied
position by position.

Public API (functions bound to a ModelConfig, forward only, under
``torch.no_grad``):

* ``param_defs(cfg)``                        — ParamDef tree
* ``forward_train(params, batch, cfg)``      — final hidden states
* ``cache_defs(cfg, batch, seq_len)``        — decode-state ParamDef tree
* ``prefill_forward(params, batch, cfg)``    — last-token logits + cache
* ``decode_step(params, state, batch, cfg)`` — one-token serve step

Other mixers and ffns raise ``NotImplementedError`` naming their ROADMAP
item; ``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_decode,
    attention_train,
    make_attention_defs,
    make_ffn_defs,
    make_norm_def,
    rms_norm,
    swiglu,
)
from repro_torch.models.spec import pdef, stack_defs, tree_map


def _not_ported(what: str, name: str) -> NotImplementedError:
    item = 3 if name == "ssd" else 4     # the SSM slice, or the remaining mixers
    return NotImplementedError(
        f"{what} {name!r} is not ported yet: ROADMAP.md, 'Next slices' item {item}")


def _check_supported(cfg: ModelConfig) -> None:
    cfg.validate()
    for mixer, ffn in cfg.block_kinds():
        if mixer != "attn":
            raise _not_ported("mixer", mixer)
        if ffn != "dense":
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


def _stack_leaves(trees: list) -> Any:
    """Inverse of :func:`_layer`: stack per-layer trees on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# per-block parameter trees
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig) -> dict:
    """Parameters of one ("attn", "dense") block."""
    return {"ln1": make_norm_def(cfg.d_model), "attn": make_attention_defs(cfg),
            "ln2": make_norm_def(cfg.d_model), "ffn": make_ffn_defs(cfg.d_model, cfg.d_ff)}


def _apply_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + swiglu(params["ffn"], rms_norm(x, params["ln2"], cfg.norm_eps))


def block_train(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + attention_train(params["attn"], h, cfg)
    return _apply_ffn(params, x, cfg)


def block_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, c = attention_decode(params["attn"], h, cache["attn"], cfg)
    x = _apply_ffn(params, x + y, cfg)
    return x, {**cache, "attn": c}


def block_prefill(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Like block_train but also captures the decode cache (prefill path)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, kvs = attention_train(params["attn"], h, cfg, return_kv=True)
    entry = {"attn": {**kvs, "len": torch.tensor(x.shape[1], dtype=torch.int32,
                                                 device=x.device)}}
    x = _apply_ffn(params, x + y, cfg)
    return x, entry


# ---------------------------------------------------------------------------
# cache parameter trees (decode state)
# ---------------------------------------------------------------------------


def _block_cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
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
        {str(u): stack_defs(block_defs(cfg), repeats) for u in range(len(unit))}
        for unit, repeats in cfg.scan_segments()
    ]
    return defs


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-state tree matching the segment structure."""
    _check_supported(cfg)
    return {
        "segments": [
            {str(u): stack_defs(_block_cache_defs(cfg, batch, seq_len), repeats)
             for u in range(len(unit))}
            for unit, repeats in cfg.scan_segments()
        ],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(batch["inputs"], params["embed"]).to(cfg.cdtype)


@torch.no_grad()
def forward_train(params: dict, batch: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, None, torch.Tensor]:
    """Returns (hidden (B,S,d) after the final norm, enc_out (None: no
    encoder in this slice), aux_loss (0: no MoE in this slice))."""
    x = embed_inputs(params, batch, cfg)
    for seg_params, (unit, repeats) in zip(params["segments"], cfg.scan_segments()):
        for i in range(repeats):
            layer_params = _layer(seg_params, i)
            for u in range(len(unit)):
                x = block_train(layer_params[str(u)], x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, None, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()


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
            for u in range(len(unit)):
                x, entry[str(u)] = block_prefill(layer_params[str(u)], x, cfg)
            entries.append(entry)
        segments_cache.append(_stack_leaves(entries))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1:], cfg)
    return logits, {"segments": segments_cache}


@torch.no_grad()
def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  batch: {"inputs": (B,1) ids}.  Returns (logits,
    state); the state's caches are updated in place."""
    x = embed_inputs(params, batch, cfg)
    for seg_params, seg_cache, (unit, repeats) in zip(
            params["segments"], state["segments"], cfg.scan_segments()):
        for i in range(repeats):
            layer_params, layer_cache = _layer(seg_params, i), _layer(seg_cache, i)
            for u in range(len(unit)):
                x, _ = block_decode(layer_params[str(u)], x, layer_cache[str(u)], cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), state
