"""Parameter specification trees.

Every model defines its parameters once as a tree (nested dicts and
lists) of :class:`ParamDef` (shape + *logical axes* + init).  From that
single definition we derive:

* ``materialize(defs, seed, device)`` — real initialized tensors;
* ``abstract(defs)``                  — ``meta``-device stand-ins (no
                                        allocation);
* ``logical_axes(defs)``              — the logical-axis tree.

Logical axis names follow ``repro.models.spec``: ``batch seq d_model
heads kv_heads head_dim d_ff vocab experts state conv none ...``
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, logical axes (one name per dim), init scale."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"           # normal | zeros | ones | scaled
    scale: float | None = None     # None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def pdef(*shape_axes: tuple[int, str | None], init: str = "normal",
         scale: float | None = None, dtype: torch.dtype = torch.bfloat16) -> ParamDef:
    """``pdef((512,'d_model'), (2048,'d_ff'))``"""
    shape = tuple(s for s, _ in shape_axes)
    axes = tuple(a for _, a in shape_axes)
    return ParamDef(shape, axes, init=init, scale=scale, dtype=dtype)


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """Map ``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_zip_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the matching leaves of trees of one structure,
    matched by dict key and list index (not by their order)."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_zip_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None) -> list:
    """Leaves in ``tree_map`` order (dict insertion order, list order)."""
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


def abstract(defs: Any) -> Any:
    """``meta``-device tensors — zero allocation, dry-run input."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"),
                    defs, is_def)


def logical_axes(defs: Any) -> Any:
    return tree_map(lambda d: d.axes, defs, is_def)


def param_count(defs: Any) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs, is_def))


def param_bytes(defs: Any) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(defs, is_def))


# a leaf of more elements than DRAW_WHOLE draws its fp32 normals in slices
# of at most DRAW_SLICE elements, straight into the stored dtype: in one
# piece a stacked FFN leaf of llava-next-34b (60 x 7168 x 20480) would take
# 35 GB of fp32 beside the weights already drawn
DRAW_WHOLE, DRAW_SLICE = 1 << 31, 1 << 28


def materialize(defs: Any, seed: int, device: str | torch.device) -> Any:
    """Real tensors on ``device``.  Each leaf draws from its own
    ``torch.Generator``, seeded from ``(seed, leaf index)`` — the
    counterpart of the reference's ``fold_in(key, i)`` — in one piece, or
    above DRAW_WHOLE elements slice by slice over its leading axes.  The
    numbers differ from JAX's; tests carry JAX weights across with
    :func:`repro_torch.bridge.params_from_numpy` instead."""
    device = torch.device(device)
    counter = iter(range(len(tree_leaves(defs, is_def))))

    def init_one(d: ParamDef) -> torch.Tensor:
        i = next(counter)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        leaf_seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        gen = torch.Generator(device=device).manual_seed(leaf_seed)
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        if math.prod(d.shape) <= DRAW_WHOLE:
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
            return x.mul_(scale).to(d.dtype)
        lead = 1                   # leading axes to slice over
        while math.prod(d.shape[lead:]) > DRAW_SLICE:
            lead += 1
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        for part in out.view(-1, *d.shape[lead:]):
            part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                                   device=device).mul_(scale))
        return out

    return tree_map(init_one, defs, is_def)


def stack_defs(defs: Any, n: int, axis_name: str = "layers") -> Any:
    """Stack a layer's ParamDef tree n times along a new leading 'layers'
    axis (the reference's scan-over-layers layout, kept so that weights
    carry across as a plain tree map)."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                           init=d.init, scale=d.scale, dtype=d.dtype),
        defs, is_def)
