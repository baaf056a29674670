"""Lineage-aware task-output store: the engine-layer checkpoint/restart plane.

The training plane already has :class:`~repro_torch.checkpoint.store.
CheckpointManager` for model state; this module is the *task* analog —
the framework-layer recovery the paper says hierarchical retry must
compose with (Dichev et al.'s dependency-aware checkpoint-restart, MODC's
idempotent-task + persisted-results recipe).  Every committed task result
is keyed by a deterministic **invocation hash** over

* the task template name,
* the fully-resolved positional/keyword arguments — parent
  :class:`~repro_torch.engine.task.AppFuture`\\ s have already been replaced by
  their results when the key is computed (at dispatch, after dependency
  resolution), so the key transitively covers every ancestor's output,

which makes the task DAG the engine already maintains
(``TaskRecord.depends_on``) the *lineage*: a restarted engine replaying
the same workflow script recomputes the same keys for every task whose
ancestry is unchanged, hits the store, and resolves those futures without
dispatching — only the incomplete frontier (tasks that never committed,
or whose ancestors now produce different results and therefore different
keys) re-executes.

Two pieces:

* :class:`TaskStore` — the persistence layer.  ``directory=None`` keeps
  everything in memory (it still survives an engine teardown, since the
  store object outlives :class:`~repro_torch.engine.dfk.DataFlowKernel`
  incarnations — exactly what the simulation plane's ``engine_crash``
  scenarios exercise); with a directory every commit is two atomic
  renames (value pickle first, JSON meta last — the meta file is the
  commit marker, so a crash mid-commit leaves an orphan value file that
  the next open sweeps).  Each entry records its parents' lineage keys,
  giving the store the reverse DAG needed for **dependency-aware
  rollback**: invalidating a key can drop every transitive descendant.
* :class:`CheckpointPolicy` — the store as a
  :class:`~repro_torch.engine.policies.ResiliencePolicy` stack member:
  ``memo_lookup`` is the dispatch-time short-circuit, ``on_result``
  commits successful results, ``memo_invalidate`` is the rollback hook
  the engine fires when a cached result fails result validation.

Wire-up is one kwarg at either level::

    store = TaskStore("results/")            # or TaskStore() in-memory
    with DataFlowKernel(cluster, checkpoint=store) as dfk: ...
    with dfk.workflow("stage2", checkpoint=store) as wf: ...

This is a copy of ``src/repro/checkpoint/task_store.py`` with the imports
rewritten and one deliberate edit: :func:`hash_value` hashes a
``torch.Tensor`` by dtype, shape and bytes, as the reference hashes a
``jax.Array`` through its ``tobytes``.  A tensor has no ``tobytes``, so the
reference's code would pickle it, and equal values (a view and its clone,
a CUDA tensor and its host copy) would get different lineage keys.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import sys
import threading
import weakref
from pathlib import Path
from typing import Any, Iterable

from repro_torch.engine.policies import ResiliencePolicy
from repro_torch.engine.retry_api import SchedulingContext

__all__ = ["TaskStore", "CheckpointPolicy", "as_checkpoint_policy",
           "lineage_key", "hash_value"]

_META_SUFFIX = ".json"
_VALUE_SUFFIX = ".pkl"
_TMP_PREFIX = ".tmp-"
#: every store key is a sha256 hex digest; scans and sweeps only ever
#: touch files with such names, so a store pointed at a directory that
#: also holds unrelated user files never deletes them
_KEY_RE = re.compile(r"[0-9a-f]{64}")


# --------------------------------------------------------------------------
# deterministic hashing
# --------------------------------------------------------------------------
def _chunk(tag: bytes, payload: bytes) -> bytes:
    """Self-delimiting encoding: tag + byte length + payload.

    The length prefix makes concatenated chunks unambiguous — without it
    adjacent variable-length elements could collide (``("aS", "b")`` vs
    ``("a", "Sb")``) and two different invocations would share one
    lineage key, silently memo-hitting the wrong result.
    """
    return tag + str(len(payload)).encode() + b":" + payload


def _feed(h: "hashlib._Hash", obj: Any) -> None:
    """Feed a canonical byte encoding of ``obj`` into ``h``.

    Type tags keep ``1`` / ``1.0`` / ``True`` / ``"1"`` distinct; dict
    items are sorted by their own hashes so insertion order never leaks
    into the key.  Unknown objects go through ``pickle`` (deterministic
    for the value types tasks realistically exchange); anything
    unpicklable degrades to ``repr`` — a weaker key that may miss across
    processes, never a wrong hit.
    """
    if obj is None:
        h.update(b"N:")
    elif isinstance(obj, bool):
        h.update(b"B1:" if obj else b"B0:")
    elif isinstance(obj, int):
        h.update(_chunk(b"I", str(obj).encode()))
    elif isinstance(obj, float):
        h.update(_chunk(b"F", obj.hex().encode()))
    elif isinstance(obj, str):
        h.update(_chunk(b"S", obj.encode()))
    elif isinstance(obj, bytes):
        h.update(_chunk(b"Y", obj))
    elif isinstance(obj, (list, tuple)):
        h.update((b"L" if isinstance(obj, list) else b"T")
                 + str(len(obj)).encode() + b":")
        for x in obj:
            _feed(h, x)
    elif isinstance(obj, (set, frozenset)):
        h.update(b"E" + str(len(obj)).encode() + b":")
        for d in sorted(hash_value(x) for x in obj):
            h.update(d.encode())          # fixed-width hex digests
    elif isinstance(obj, dict):
        h.update(b"D" + str(len(obj)).encode() + b":")
        for kd, vd in sorted((hash_value(k), hash_value(v))
                             for k, v in obj.items()):
            h.update(kd.encode() + vd.encode())
    elif "torch" in sys.modules and isinstance(obj, sys.modules["torch"].Tensor):
        # tensors by value, as ndarrays below: a view equals its clone and
        # a CUDA tensor its host copy, where pickle would carry the whole
        # storage and the device; bytes as uint8, so bf16 hashes too.
        # torch is looked up, not imported: no tensor exists before it loads
        flat = obj.detach().cpu().contiguous().reshape(-1)
        h.update(_chunk(b"A", str(obj.dtype).encode()
                        + str(tuple(obj.shape)).encode()))
        h.update(_chunk(b"a", flat.view(sys.modules["torch"].uint8).numpy().tobytes()))
    elif hasattr(obj, "dtype") and hasattr(obj, "tobytes"):
        # ndarray-likes (numpy / jax device arrays): dtype + shape + bytes
        h.update(_chunk(b"A", str(obj.dtype).encode()
                        + str(getattr(obj, "shape", ())).encode()))
        h.update(_chunk(b"a", obj.tobytes() if callable(obj.tobytes)
                        else bytes(obj)))
    else:
        try:
            h.update(_chunk(b"P", pickle.dumps(obj, protocol=4)))
        except Exception:  # noqa: BLE001 - unhashable arg => weak (repr) key
            h.update(_chunk(b"R", repr(obj).encode()))


def hash_value(obj: Any) -> str:
    """Deterministic content hash of an arbitrary task argument/result."""
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()


#: fn -> code fingerprint; weak so task functions can be collected
_fn_prints: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _code_bytes(code: Any) -> bytes:
    """Deterministic bytes for a code object: bytecode + consts + names.

    Nested code objects (lambdas, comprehensions) recurse instead of
    taking ``repr`` — a code object's repr embeds a memory address and
    would differ every process.  Frozenset consts are sorted by repr for
    the same reason (str-hash randomization shuffles their iteration).
    """
    parts = [code.co_code]
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            parts.append(_code_bytes(c))
        elif isinstance(c, frozenset):
            parts.append(repr(sorted(c, key=repr)).encode())
        else:
            parts.append(repr(c).encode())
    parts.append(" ".join(code.co_names).encode())
    return b"|".join(parts)


def _fn_fingerprint(fn: Any) -> bytes:
    """Content fingerprint of a task's implementation.

    Keys must change when the task's *code* changes, or a persistent
    store would silently serve results computed by an older
    implementation (and two distinct templates sharing a ``__name__``
    would alias).  Bytecode + consts + referenced names is the proxy;
    changes visible only through globals/closure *values* are not
    captured — same-code-same-behaviour remains the caller's contract,
    as in any memoizing runtime.
    """
    try:
        return _fn_prints[fn]
    except (KeyError, TypeError):
        pass
    code = getattr(fn, "__code__", None)
    if code is None:                      # builtins / callables: name-level
        fp = getattr(fn, "__qualname__", type(fn).__qualname__).encode()
    else:
        fp = hashlib.sha256(_code_bytes(code)).digest()
    try:
        _fn_prints[fn] = fp
    except TypeError:                     # unweakrefable callable
        pass
    return fp


def lineage_key(rec: Any) -> str:
    """Invocation hash of a task record whose args are fully resolved.

    Must be called *after* dependency resolution (parent futures replaced
    by their results): the key then covers template name + implementation
    fingerprint + resolved args + every parent's output, i.e. the task's
    full lineage.
    """
    h = hashlib.sha256()
    h.update(_chunk(b"task", rec.name.encode()))
    fn = getattr(rec, "fn", None)
    if fn is not None:
        h.update(_chunk(b"code", _fn_fingerprint(fn)))
    _feed(h, tuple(rec.args))
    _feed(h, dict(rec.kwargs))
    return h.hexdigest()


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------
class TaskStore:
    """Task results keyed by lineage hash, with parent links for rollback.

    Thread-safe; an instance may be shared by several engine incarnations
    (that is the whole point — it is the state that survives a crash).
    """

    def __init__(self, directory: str | Path | None = None):
        self.directory = Path(directory) if directory is not None else None
        self._lock = threading.RLock()
        #: key -> {"task_name": str, "parents": list[str], "value_hash": str}
        self._entries: dict[str, dict[str, Any]] = {}
        self._values: dict[str, Any] = {}      # in-memory value cache
        self._loaded: set[str] = set()         # keys whose value is cached
        if self.directory is not None:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._open()

    # -- disk layout -------------------------------------------------------
    def _meta_path(self, key: str) -> Path:
        assert self.directory is not None
        return self.directory / f"{key}{_META_SUFFIX}"

    def _value_path(self, key: str) -> Path:
        assert self.directory is not None
        return self.directory / f"{key}{_VALUE_SUFFIX}"

    def _open(self) -> None:
        """Load committed entries; sweep tmp files and orphan values.

        The JSON meta file is the commit marker (written last): a value
        pickle without its meta is an interrupted commit and is removed,
        as is any leftover ``.tmp-*`` from a crash mid-rename.  Only
        sha256-keyed names are scanned or swept — files the store did not
        write (a user's own ``analysis.json``/``model.pkl`` sharing the
        directory) are never touched.
        """
        assert self.directory is not None
        for p in self.directory.glob(f"{_TMP_PREFIX}*"):
            stem = p.name[len(_TMP_PREFIX):]
            for suffix in (_META_SUFFIX, _VALUE_SUFFIX):
                if (stem.endswith(suffix)
                        and _KEY_RE.fullmatch(stem[: -len(suffix)])):
                    p.unlink(missing_ok=True)
        committed: set[str] = set()
        for p in self.directory.glob(f"*{_META_SUFFIX}"):
            key = p.name[: -len(_META_SUFFIX)]
            if not _KEY_RE.fullmatch(key):
                continue
            try:
                meta = json.loads(p.read_text())
            except (OSError, ValueError):
                p.unlink(missing_ok=True)
                continue
            if not self._value_path(key).exists():
                p.unlink(missing_ok=True)
                continue
            self._entries[key] = meta
            committed.add(key)
        for p in self.directory.glob(f"*{_VALUE_SUFFIX}"):
            key = p.name[: -len(_VALUE_SUFFIX)]
            if _KEY_RE.fullmatch(key) and key not in committed:
                p.unlink(missing_ok=True)

    def _atomic_write(self, path: Path, data: bytes) -> None:
        assert self.directory is not None
        tmp = self.directory / f"{_TMP_PREFIX}{path.name}"
        tmp.write_bytes(data)
        os.replace(tmp, path)

    # -- core API ----------------------------------------------------------
    def lookup(self, key: str) -> tuple[bool, Any]:
        """Return ``(hit, value)``; a corrupt on-disk value counts as a
        miss and is invalidated (descendants included) so stale children
        cannot outlive an unreadable parent."""
        with self._lock:
            if key not in self._entries:
                return False, None
            if key in self._loaded:
                return True, self._values.get(key)
            try:
                value = pickle.loads(self._value_path(key).read_bytes())
            except Exception:  # noqa: BLE001 - corrupt entry => miss + rollback
                self.invalidate(key, descendants=True)
                return False, None
            self._values[key] = value
            self._loaded.add(key)
            return True, value

    def commit(self, key: str, value: Any, *, task_name: str = "",
               parents: Iterable[str] = ()) -> str:
        """Persist a result; returns its content hash.

        Re-committing an identical value only *unions in* any new parent
        keys — converging lineages (two different parents producing the
        same value, hence one child key) must all be linked or
        dependency-aware rollback would miss descendants.  A *different*
        value overwrites; its descendants' keys change anyway, so no
        rollback is needed here.
        """
        if not _KEY_RE.fullmatch(key):
            raise ValueError(
                f"task-store keys are sha256 hex digests (use lineage_key()"
                f" / hash_value()); got {key!r}")
        vhash = hash_value(value)
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None and prev.get("value_hash") == vhash:
                merged = sorted(set(prev.get("parents", ())) | set(parents))
                if merged != prev.get("parents"):
                    meta = dict(prev, parents=merged)
                    if self.directory is not None:
                        self._atomic_write(self._meta_path(key),
                                           json.dumps(meta).encode())
                    self._entries[key] = meta
                return vhash
            meta = {"task_name": task_name, "parents": sorted(set(parents)),
                    "value_hash": vhash}
            if self.directory is not None:
                self._atomic_write(self._value_path(key),
                                   pickle.dumps(value, protocol=4))
                self._atomic_write(self._meta_path(key),
                                   json.dumps(meta).encode())
            self._entries[key] = meta
            self._values[key] = value
            self._loaded.add(key)
            return vhash

    def invalidate(self, key: str, *, descendants: bool = False) -> list[str]:
        """Drop an entry (and, with ``descendants=True``, every entry
        whose parent chain reaches it).  Returns the removed keys."""
        with self._lock:
            doomed = [key]
            if descendants:
                children: dict[str, list[str]] = {}
                for k, meta in self._entries.items():
                    for parent in meta.get("parents", ()):
                        children.setdefault(parent, []).append(k)
                frontier, seen = [key], {key}
                while frontier:
                    nxt = frontier.pop()
                    for child in children.get(nxt, ()):
                        if child not in seen:
                            seen.add(child)
                            doomed.append(child)
                            frontier.append(child)
            removed = []
            for k in doomed:
                if k in self._entries:
                    removed.append(k)
                    self._entries.pop(k, None)
                    self._values.pop(k, None)
                    self._loaded.discard(k)
                    if self.directory is not None:
                        self._meta_path(k).unlink(missing_ok=True)
                        self._value_path(k).unlink(missing_ok=True)
            return removed

    # -- introspection -----------------------------------------------------
    def keys(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def entry(self, key: str) -> dict[str, Any] | None:
        with self._lock:
            meta = self._entries.get(key)
            return dict(meta) if meta is not None else None

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        where = str(self.directory) if self.directory else "memory"
        return f"<TaskStore {where} entries={len(self)}>"


# --------------------------------------------------------------------------
# the policy
# --------------------------------------------------------------------------
class CheckpointPolicy(ResiliencePolicy):
    """The task-output store as resilience middleware.

    * ``memo_lookup`` (dispatch time, args resolved): compute the
      record's lineage key and probe the store — a hit short-circuits
      dispatch, the engine resolves the future with the cached result;
    * ``memo_commit``: persist a successful result under the record's
      lineage key, linking it to its parents' keys.  The engine fires
      this only for the attempt that actually *won* the task (after the
      duplicate-completion guard), so a discarded racing copy of a
      nondeterministic task can never overwrite the value the future
      resolved with;
    * ``memo_invalidate``: dependency-aware rollback — drop the record's
      entry *and every descendant* when its cached result fails the
      stack's result validation.

    Failures are deliberately never committed: a destined-to-fail task
    re-executes after a restart, exactly like a fresh run.
    """

    def __init__(self, store: TaskStore | str | Path | None = None):
        if store is None:
            store = TaskStore()
        elif not isinstance(store, TaskStore):
            store = TaskStore(store)
        self.store: TaskStore = store

    def _key(self, rec: Any) -> str:
        key = getattr(rec, "lineage_key", None)
        if key is None:
            key = lineage_key(rec)
            rec.lineage_key = key
        return key

    def memo_lookup(self, rec: Any, ctx: SchedulingContext) -> tuple[bool, Any]:
        return self.store.lookup(self._key(rec))

    def memo_invalidate(self, rec: Any, reason: str = "") -> list[str]:
        key = getattr(rec, "lineage_key", None)
        if key is None:
            return []
        return self.store.invalidate(key, descendants=True)

    def memo_commit(self, rec: Any, result: Any,
                    ctx: SchedulingContext) -> None:
        parents = [p.lineage_key for p in getattr(rec, "depends_on", ())
                   if getattr(p, "lineage_key", None)]
        self.store.commit(self._key(rec), result, task_name=rec.name,
                          parents=parents)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<CheckpointPolicy {self.store!r}>"


def as_checkpoint_policy(checkpoint: Any) -> CheckpointPolicy:
    """Coerce the public ``checkpoint=`` argument into a policy.

    Accepts a :class:`CheckpointPolicy`, a :class:`TaskStore`, a
    directory path (``str``/``Path``), or ``True`` (fresh in-memory
    store).
    """
    if isinstance(checkpoint, CheckpointPolicy):
        return checkpoint
    if isinstance(checkpoint, TaskStore):
        return CheckpointPolicy(checkpoint)
    if checkpoint is True:
        return CheckpointPolicy(TaskStore())
    if isinstance(checkpoint, (str, Path)):
        return CheckpointPolicy(TaskStore(checkpoint))
    raise TypeError(
        f"checkpoint= expects a CheckpointPolicy, TaskStore, path or True; "
        f"got {checkpoint!r}")
