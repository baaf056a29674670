"""Assigned input-shape presets and their abstract inputs (the port of
``repro.launch.shapes``): ``meta``-device tensors of the reference's
shapes and dtypes, zero allocation.

LM transformer shapes are seq_len × global_batch.  ``decode_*`` /
``long_*`` run ``serve_step`` (one new token with a seq_len cache);
``prefill_*`` runs ``prefill_step``; ``train_*`` runs ``train_step``.
``long_500k`` only applies to sub-quadratic archs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_defs, param_defs
from repro_torch.models.spec import abstract


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k needs a sub-quadratic architecture."""
    sp = SHAPES[shape]
    if sp.name == "long_500k" and not cfg.subquadratic:
        return False, (f"{cfg.name} is pure full-attention; 500k context is "
                       f"architecturally unsupported (quadratic prefill)")
    return True, ""


def _token_spec(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def _embed_spec(b: int, s: int, d: int) -> torch.Tensor:
    return torch.empty((b, s, d), dtype=torch.bfloat16, device="meta")


def batch_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta tensors for the *batch* argument of the step."""
    sp = SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    if sp.kind in ("train", "prefill"):
        out: dict = {}
        if cfg.encoder_layers:
            out["enc_embeds"] = _embed_spec(b, s, cfg.d_model)
            out["inputs"] = _token_spec(b, s)
        elif cfg.input_kind == "embeds":
            out["embeds"] = _embed_spec(b, s, cfg.d_model)
        else:
            out["inputs"] = _token_spec(b, s)
        if sp.kind == "train":
            out["targets"] = _token_spec(b, s)
        return out
    # decode: one new token
    return {"inputs": _token_spec(b, 1)}


def cache_specs(cfg: ModelConfig, shape: str) -> dict:
    sp = SHAPES[shape]
    return abstract(cache_defs(cfg, sp.global_batch, sp.seq_len))


def param_specs(cfg: ModelConfig) -> dict:
    return abstract(param_defs(cfg))


def batch_axes(cfg: ModelConfig, shape: str) -> dict:
    """Logical axes for each batch leaf (drives input placements)."""
    sp = SHAPES[shape]
    axes: dict = {}
    if sp.kind in ("train", "prefill"):
        if cfg.encoder_layers:
            axes["enc_embeds"] = ("batch", "seq", "d_model")
            axes["inputs"] = ("batch", "seq")
        elif cfg.input_kind == "embeds":
            axes["embeds"] = ("batch", "seq", "d_model")
        else:
            axes["inputs"] = ("batch", "seq")
        if sp.kind == "train":
            axes["targets"] = ("batch", "seq")
        return axes
    return {"inputs": ("batch", "seq")}
