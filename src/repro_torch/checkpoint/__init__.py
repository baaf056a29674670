"""Training-plane checkpoints (``store``).  The engine plane's task-output
store (``src/repro/checkpoint/task_store.py``) is copied with the engine:
ROADMAP.md, Queue 1 item 4."""
from repro_torch.checkpoint.store import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]
