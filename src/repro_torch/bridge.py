"""Carry parameter and cache trees across from the JAX package.

The port keeps the reference's tree layout (``segments[i][str(u)][name]``
with a leading layers axis), so carrying weights across is a plain tree
map: convert the JAX tree to numpy (``jax.tree.map(np.asarray, tree)``)
and hand it to :func:`params_from_numpy`.  This module itself imports
neither jax nor ml_dtypes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.spec import tree_map


def _to_tensor(a: Any, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16: ml_dtypes' arrays go across bit for bit
        t = torch.from_numpy(a.copy().view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device: str | torch.device,
                      dtype: torch.dtype | None = None) -> Any:
    """numpy tree (nested dicts/lists) -> torch tree with the same names
    and layout on ``device``.  ``dtype`` recasts floating leaves (integer
    leaves such as the caches' ``len`` keep theirs)."""
    device = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)
