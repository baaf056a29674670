"""AdamW with dtype-configurable moments and a warmup-cosine schedule.

Ports ``src/repro/optim/adamw.py``.  Functional, as the reference: an
update returns new parameter and state trees and leaves its inputs as
they were.  Leaves are updated one after another, so the fp32
temporaries of only one leaf are alive at a time (granite-3-2b's stacked
FFN leaves hold 671 M values, 2.7 GB each in fp32), and each leaf's
arithmetic reuses its temporaries in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.spec import ParamDef, is_def, tree_leaves, tree_map, tree_zip_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" for the huge cells

    @property
    def mdtype(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)


def lr_at(step: torch.Tensor | int, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (fp32 scalar on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def opt_state_defs(param_defs_tree: Any, cfg: OptConfig) -> dict:
    """Abstract Adam state (for the dry-run): m, v mirror params."""

    def moment(d: ParamDef) -> ParamDef:
        return ParamDef(d.shape, d.axes, init="zeros", dtype=cfg.mdtype)

    return {
        "m": tree_map(moment, param_defs_tree, is_def),
        "v": tree_map(moment, param_defs_tree, is_def),
        "count": ParamDef((), (), init="zeros", dtype=torch.int32),
    }


def init_opt_state(params: Any, cfg: OptConfig) -> dict:
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.mdtype, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.mdtype, device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_apply(params: Any, grads: Any, state: dict, cfg: OptConfig
                ) -> tuple[Any, dict, dict]:
    """One AdamW update.  Returns (params, state, metrics); the inputs are
    not modified."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    lr = lr_at(count, cfg)
    countf = count.to(torch.float32)
    b1c = 1 - cfg.b1 ** countf
    b2c = 1 - cfg.b2 ** countf

    def upd(p, g, m, v):
        g32 = g.to(torch.float32, copy=True).mul_(scale)
        m32 = m.to(torch.float32, copy=True).mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v32 = v.to(torch.float32, copy=True).mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        step = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and p.dim() >= 2:
            step.add_(p.float(), alpha=cfg.weight_decay)
        newp = p.to(torch.float32, copy=True).sub_(step.mul_(lr))
        return newp.to(p.dtype), m32.to(cfg.mdtype), v32.to(cfg.mdtype)

    new = tree_zip_map(upd, params, grads, state["m"], state["v"])

    def part(i: int) -> Any:
        return tree_map(lambda n: n[i], new, is_leaf=lambda n: isinstance(n, tuple))

    new_p, new_m, new_v = part(0), part(1), part(2)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics
