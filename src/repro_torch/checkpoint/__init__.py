"""Checkpointing: training-plane state (``store``) + engine-plane task
outputs (``task_store``).

The training-plane symbols import torch, which the engine layer must not
pay for just to memoize task results — they resolve lazily via module
``__getattr__``; the jax-free task store loads eagerly.
"""
from repro_torch.checkpoint.task_store import (
    CheckpointPolicy,
    TaskStore,
    as_checkpoint_policy,
    hash_value,
    lineage_key,
)

__all__ = [
    "CheckpointManager", "save_checkpoint", "load_checkpoint",
    "TaskStore", "CheckpointPolicy", "as_checkpoint_policy",
    "lineage_key", "hash_value",
]

_LAZY = ("CheckpointManager", "save_checkpoint", "load_checkpoint")


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.checkpoint import store
        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
