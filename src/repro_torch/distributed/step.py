"""Step builders: prefill_step / serve_step.

Ports ``build_prefill_step`` and ``build_serve_step`` of
``src/repro/distributed/step.py``.  PyTorch runs eagerly, so a builder
returns a plain function; ``build_train_step`` comes with the training
slice (ROADMAP.md, 'Next slices' item 2).
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill_forward


def build_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> (last-token logits, decode cache)."""

    def prefill_step(params: Any, batch: dict):
        return prefill_forward(params, batch, cfg)

    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """(params, cache, batch) -> (logits, cache) — one decoded token; the
    cache is updated in place."""

    def serve_step(params: Any, cache: dict, batch: dict):
        return decode_step(params, cache, batch, cfg)

    return serve_step
