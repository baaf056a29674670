"""Checkpointing: atomic commit, retention, async save, restore onto a
device.

Ports ``src/repro/checkpoint/store.py`` with the same on-disk layout, so a
checkpoint written by either package restores into the other::

    <dir>/step_00000100/
        manifest.json         # leaf keys, shapes, dtypes, metadata
        shard_00000.npz       # flattened leaves, chunked by byte budget
        ...
        COMMITTED             # written last — crash-safe commit marker

Leaf keys are the reference's ``tree_flatten_with_path`` keys
(``segments/0/0/attn/wq``, dict keys in sorted order).  numpy has no
bfloat16: a bf16 leaf is stored as its uint16 bit pattern with the
logical dtype ``"bfloat16"`` in the manifest, as the reference stores
ml_dtypes' arrays, and read back by a view, without ml_dtypes.
``load_checkpoint`` takes ``device=`` where the reference takes
``shardings=``.

The paper's framework-layer recovery (restart component → retry) maps to
``CheckpointManager.restore_latest()`` after a training-plane failure.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

_COMMIT = "COMMITTED"


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items in order, ``/`` between path parts."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(tree_like: Any, get, prefix: str = "") -> Any:
    """A tree shaped like ``tree_like`` whose leaf at key ``k`` is ``get(k, like)``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree_like, dict):
        return {k: _unflatten(v, get, key(k)) for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, get, key(i)) for i, v in enumerate(tree_like))
    return get(prefix, tree_like)


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as the array to store and its logical dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.astype(np.uint16, copy=False).view(np.int16).copy()
                                ).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise TypeError(f"checkpoint leaf of dtype {dtype!r} stored as {arr.dtype}: "
                        "this package reads bfloat16 and numpy dtypes only")
    return torch.from_numpy(np.array(arr, copy=True))


def save_checkpoint(directory: str | Path, step: int, tree: Any, *,
                    metadata: dict | None = None,
                    shard_mb: int = 256) -> Path:
    """Atomic checkpoint save; returns the committed directory."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: dict[str, Any] = {
        "step": step,
        "time": time.time(),
        "metadata": metadata or {},
        "leaves": [],
    }
    budget = shard_mb * 2**20
    shard_idx, shard_bytes, shard_data = 0, 0, {}

    def flush():
        nonlocal shard_idx, shard_bytes, shard_data
        if shard_data:
            np.savez(tmp / f"shard_{shard_idx:05d}.npz", **shard_data)
            shard_idx += 1
            shard_bytes, shard_data = 0, {}

    for key, leaf in _flatten(tree):
        arr, dtype_str = _to_numpy(leaf)
        nkey = key.replace("/", "|")       # npz keys cannot contain '/'
        manifest["leaves"].append({
            "key": key, "npz_key": nkey, "shard": None,
            "shape": list(arr.shape), "dtype": dtype_str})
        if shard_bytes + arr.nbytes > budget:
            flush()
        manifest["leaves"][-1]["shard"] = shard_idx
        shard_data[nkey] = arr
        shard_bytes += arr.nbytes
    flush()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / _COMMIT).write_text(str(time.time()))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def load_checkpoint(path: str | Path, tree_like: Any, *,
                    device: str | torch.device | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like``.

    Each leaf goes to ``device``, or where the matching leaf of
    ``tree_like`` lies (the CPU for a leaf that is not a tensor)."""
    path = Path(path)
    if not (path / _COMMIT).exists():
        raise FileNotFoundError(f"checkpoint {path} is not committed")
    manifest = json.loads((path / "manifest.json").read_text())
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    shards: dict[int, Any] = {}

    def get(key: str, like: Any) -> torch.Tensor:
        info = by_key[key]
        si = info["shard"]
        if si not in shards:
            shards[si] = np.load(path / f"shard_{si:05d}.npz")
        t = _to_tensor(shards[si][info["npz_key"]], info["dtype"])
        target = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        return t.to(target)

    tree = _unflatten(tree_like, get)
    return tree, manifest["metadata"] | {"step": manifest["step"]}


def _snapshot(tree: Any) -> Any:
    """Host copies of a tree's tensors, taken before an async write."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return np.array(leaf, copy=True)

    return _unflatten(tree, lambda _key, leaf: copy(leaf))


class CheckpointManager:
    """Retention + async save + latest-restore."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = False):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._sweep_tmp()  # a crash mid-save leaves orphaned .tmp_step_* dirs
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        # exception raised by the async writer thread, surfaced to the
        # caller on the next wait()/save()/restore_latest() instead of
        # dying silently in a daemon thread
        self._async_error: BaseException | None = None

    # ------------------------------------------------------------------ #
    def steps(self) -> list[int]:
        out = []
        for p in self.directory.glob("step_*"):
            if (p / _COMMIT).exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        tree = _snapshot(tree)  # snapshot before async write

        def do():
            save_checkpoint(self.directory, step, tree, metadata=metadata)
            self._retain()

        if self.async_save:
            self.wait()  # re-raises a previous async failure before queuing more

            def do_async():
                try:
                    do()
                except BaseException as e:  # noqa: BLE001 - surfaced on wait()
                    self._async_error = e

            self._pending = threading.Thread(target=do_async, daemon=True)
            self._pending.start()
        else:
            do()

    def wait(self) -> None:
        """Block until the pending async save finishes.

        Re-raises any exception the writer thread hit — a failed
        checkpoint must not be discovered only at restore time.
        """
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._async_error is not None:
            err = self._async_error
            self._async_error = None
            raise err

    def _sweep_tmp(self) -> None:
        """Remove uncommitted ``.tmp_step_*`` dirs from interrupted saves.

        Safe while a save is in flight: :func:`save_checkpoint` recreates
        its tmp dir from scratch, and the manager serializes saves (every
        ``save()`` waits for the previous async writer), so any tmp dir
        seen here belongs to a crashed writer, not a live one.
        """
        for p in self.directory.glob(".tmp_step_*"):
            shutil.rmtree(p, ignore_errors=True)

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
        self._sweep_tmp()

    def restore_latest(self, tree_like: Any, *, device: str | torch.device | None = None
                       ) -> tuple[Any, dict] | None:
        self.wait()
        steps = self.steps()
        if not steps:
            return None
        return load_checkpoint(self.directory / f"step_{steps[-1]:08d}",
                               tree_like, device=device)
