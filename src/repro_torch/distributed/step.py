"""Step builders: train_step / prefill_step / serve_step.

Ports ``src/repro/distributed/step.py``.  PyTorch runs eagerly, so a
builder returns a plain function rather than one for ``jax.jit``.
``build_train_step`` composes microbatch gradient accumulation (a loop,
cutting activation memory by the microbatch factor), the global-norm
clip and AdamW; gradients come from torch autograd over the parameter
leaves (:func:`loss_and_grads`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, loss_fn, prefill_forward
from repro_torch.models.spec import tree_leaves, tree_map, tree_zip_map
from repro_torch.optim import OptConfig, adamw_apply


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    remat: bool = True
    accum_dtype: str = "float32"     # "bfloat16" halves grad-accum memory
    ce_chunk: int = 512

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.accum_dtype)


def _like(tree: Any, leaves: list) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def batch_to(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def loss_and_grads(params: Any, batch: dict, cfg: ModelConfig, *, remat: bool = True,
                   ce_chunk: int = 512) -> tuple[torch.Tensor, dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: (loss, metrics, grads),
    grads a tree like ``params`` in the parameters' dtypes.  ``params`` is
    not modified: the leaves that autograd tracks are detached views."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch, cfg, remat=remat, ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _like(params, list(grads)))


def build_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                     step_cfg: StepConfig = StepConfig()) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    kw = dict(remat=step_cfg.remat, ce_chunk=step_cfg.ce_chunk)

    def train_step(params: Any, opt_state: dict, batch: dict):
        batch = batch_to(batch, tree_leaves(params)[0].device)
        k = step_cfg.microbatches
        if k > 1:
            gsum, lsum = None, 0.0
            for i in range(k):
                mb = {n: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
                      for n, v in batch.items()}
                loss, _, g = loss_and_grads(params, mb, cfg, **kw)
                g = tree_map(lambda x: x.to(step_cfg.adtype), g)
                gsum = g if gsum is None else tree_zip_map(torch.add, gsum, g)
                lsum = lsum + loss
                del g
            grads = tree_map(lambda g: (g / k).to(torch.float32), gsum)
            del gsum
            loss = lsum / k
            metrics: dict[str, Any] = {}
        else:
            loss, metrics, grads = loss_and_grads(params, batch, cfg, **kw)
        new_params, new_state, om = adamw_apply(params, grads, opt_state, opt_cfg)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return train_step


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
