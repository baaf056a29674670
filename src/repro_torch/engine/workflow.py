"""Workflow scopes: the task-hierarchy layer of the public API.

The paper's core observation is that TBPP workloads are *hierarchies* —
applications contain workflows contain sub-workflows contain tasks — and
resilience decisions should follow that structure (§III, §V).  A
:class:`Workflow` makes the hierarchy first-class: it is a named scope
created from a :class:`~repro_torch.engine.dfk.DataFlowKernel`, tasks invoked
inside its ``with`` block (or routed via ``TaskDef.options(workflow=...)``)
become members, and scopes nest arbitrarily deep.

Per scope you get:

* **defaults** — ``pool=`` / ``retries=`` / ``node=`` apply to member
  tasks that didn't pin their own, resolved innermost-scope-first up the
  ancestor chain;
* **policies** — ``policy=`` pushes resilience middleware
  (:mod:`repro_torch.engine.policies`) onto member tasks' stacks, between their
  per-call policies and the engine-level stack;
* **scope-wide control** — :meth:`cancel` kills every queued *and*
  running task in the subtree (descendant scopes included, sibling scopes
  untouched), :meth:`wait` blocks on the subtree, :meth:`stats`
  aggregates it;
* **failure propagation** — ``propagate="none"`` (default) contains a
  member's terminal failure to that task; ``"siblings"`` fast-fails the
  rest of this scope's subtree; ``"ancestors"`` fast-fails the entire
  ancestor chain's subtree (the whole workflow tree this scope belongs
  to).  The *innermost* scope owning the failed task decides.
"""
from __future__ import annotations

import threading
from concurrent.futures import wait as _futures_wait
from typing import TYPE_CHECKING, Any, Iterator

from repro_torch.engine.policies import ResiliencePolicy, normalize_policies
from repro_torch.engine.task import TaskRecord, TaskState

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.engine.dfk import DataFlowKernel

PROPAGATE_MODES = ("none", "siblings", "ancestors")

_TERMINAL = (TaskState.COMPLETED, TaskState.FAILED, TaskState.DEP_FAILED)


class Workflow:
    """A named scope of tasks within a DataFlowKernel session."""

    _tls = threading.local()

    def __init__(self, name: str, *, dfk: "DataFlowKernel | None" = None,
                 parent: "Workflow | None" = None, pool: str | None = None,
                 retries: int | None = None, node: str | None = None,
                 policy: Any = None, propagate: str = "none",
                 checkpoint: Any = None):
        if propagate not in PROPAGATE_MODES:
            raise ValueError(
                f"propagate must be one of {PROPAGATE_MODES}, got {propagate!r}")
        if parent is None and dfk is None:
            parent = Workflow.current()
        if dfk is None:
            if parent is not None:
                dfk = parent.dfk
            else:
                from repro_torch.engine.dfk import DataFlowKernel
                dfk = DataFlowKernel.current()
        if dfk is None:
            raise RuntimeError(
                f"workflow {name!r} created outside a DataFlowKernel session; "
                "pass dfk= or create it inside `with DataFlowKernel(...)`")
        self.name = name
        self.dfk = dfk
        self.parent = parent
        self.pool = pool
        self.retries = retries
        self.node = node
        self.policies: tuple[ResiliencePolicy, ...] = normalize_policies(policy)
        if checkpoint is not None:
            # scope-level checkpoint/restart: member tasks memoize into the
            # given TaskStore (path / store / policy), joining the scope's
            # policy chain after any explicit policies
            from repro_torch.checkpoint.task_store import as_checkpoint_policy
            self.policies = self.policies + (as_checkpoint_policy(checkpoint),)
        self.propagate = propagate
        self.children: list["Workflow"] = []
        self._records: list[TaskRecord] = []
        self._lock = threading.Lock()
        self._cancelled = False
        self.cancel_reason: str = ""
        if parent is not None:
            parent.children.append(self)
            if parent._cancelled:   # born into a killed tree: born cancelled
                self._cancelled = True
                self.cancel_reason = parent.cancel_reason
        dfk._register_workflow(self)

    # ------------------------------------------------------------------ #
    # scoping
    # ------------------------------------------------------------------ #
    @classmethod
    def current(cls) -> "Workflow | None":
        stack = getattr(cls._tls, "stack", None)
        return stack[-1] if stack else None

    def __enter__(self) -> "Workflow":
        stack = getattr(Workflow._tls, "stack", None)
        if stack is None:
            stack = Workflow._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        stack = getattr(Workflow._tls, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()

    def workflow(self, name: str, **kwargs: Any) -> "Workflow":
        """Create a nested sub-workflow of this scope."""
        return Workflow(name, parent=self, **kwargs)

    @property
    def path(self) -> str:
        """Hierarchy-qualified name, e.g. ``"pipeline/stage2/shard3"``."""
        if self.parent is None:
            return self.name
        return f"{self.parent.path}/{self.name}"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        flags = f" propagate={self.propagate}" if self.propagate != "none" else ""
        return f"<Workflow {self.path!r} tasks={len(self._records)}{flags}>"

    # ------------------------------------------------------------------ #
    # membership & scope defaults
    # ------------------------------------------------------------------ #
    def _add(self, rec: TaskRecord) -> None:
        with self._lock:
            self._records.append(rec)

    @property
    def cancelled(self) -> bool:
        """True when this scope — or any ancestor — was cancelled.

        The ancestor walk covers sub-scopes created *after* their parent
        was cancelled: they must not become an escape hatch for new work
        inside a killed tree.
        """
        return any(wf._cancelled for wf in self._chain())

    def _chain(self) -> Iterator["Workflow"]:
        """This scope, then its ancestors, innermost first."""
        wf: Workflow | None = self
        while wf is not None:
            yield wf
            wf = wf.parent

    def effective_pool(self) -> str | None:
        return next((w.pool for w in self._chain() if w.pool), None)

    def effective_retries(self) -> int | None:
        return next((w.retries for w in self._chain()
                     if w.retries is not None), None)

    def effective_node(self) -> str | None:
        return next((w.node for w in self._chain() if w.node), None)

    def chain_policies(self) -> tuple[ResiliencePolicy, ...]:
        """Policy middleware contributed by the scope chain, innermost
        scope's policies first (they shadow ancestors')."""
        out: list[ResiliencePolicy] = []
        for wf in self._chain():
            out.extend(wf.policies)
        return tuple(out)

    # ------------------------------------------------------------------ #
    # subtree views
    # ------------------------------------------------------------------ #
    def subtree(self) -> Iterator["Workflow"]:
        """This scope and every descendant scope (pre-order)."""
        yield self
        for child in list(self.children):
            yield from child.subtree()

    def tasks(self) -> list[TaskRecord]:
        """Every member task record in the subtree."""
        out: list[TaskRecord] = []
        for wf in self.subtree():
            with wf._lock:
                out.extend(wf._records)
        return out

    def futures(self) -> list[Any]:
        return [rec.future for rec in self.tasks() if rec.future is not None]

    # ------------------------------------------------------------------ #
    # scope-wide control
    # ------------------------------------------------------------------ #
    def cancel(self, reason: str = "") -> int:
        """Cancel every unfinished task in the subtree (queued *and*
        running); sibling scopes are untouched.  Returns the number of
        tasks actually cancelled."""
        reason = reason or f"workflow {self.path!r} cancelled"
        for wf in self.subtree():
            wf._cancelled = True
            wf.cancel_reason = wf.cancel_reason or reason
        n = 0
        for rec in self.tasks():
            if rec.state in _TERMINAL:
                continue
            if self.dfk.cancel_task(rec.task_id, reason=reason):
                n += 1
        if self.dfk.monitor is not None:
            self.dfk.monitor.record_system_event(
                "workflow_cancelled", workflow=self.path, reason=reason,
                cancelled=n)
        return n

    def wait(self, timeout: float | None = None) -> bool:
        """Block until every task in the subtree resolved.  Returns False
        on timeout.  On a virtual-clock engine this *drives* the event
        loop instead of blocking (``timeout`` is virtual seconds)."""
        if self.dfk.clock.virtual:
            return self.dfk._drive_until(
                lambda: all(f.done() for f in self.futures()), timeout)
        pending = self.futures()
        done, not_done = _futures_wait(pending, timeout=timeout)
        return not not_done

    def stats(self) -> dict[str, Any]:
        """Aggregate state of the subtree.  Every :class:`TaskState` gets a
        bucket, so the per-state counts always sum to ``tasks``."""
        recs = self.tasks()
        by_state: dict[str, int] = {}
        retries = 0
        for rec in recs:
            by_state[rec.state.value] = by_state.get(rec.state.value, 0) + 1
            retries += rec.retry_count
        return {
            "workflow": self.path,
            "tasks": len(recs),
            "retries": retries,
            "scopes": sum(1 for _ in self.subtree()),
            "cancelled": self.cancelled,
            **{s.value: by_state.get(s.value, 0) for s in TaskState},
        }

    # ------------------------------------------------------------------ #
    # failure propagation
    # ------------------------------------------------------------------ #
    def on_member_failed(self, rec: TaskRecord) -> None:
        """A member task terminally failed: apply this scope's propagation
        policy.  Called by the engine; the innermost owning scope decides."""
        if self._cancelled or self.propagate == "none":
            return
        reason = (f"propagated failure: task {rec.task_id} ({rec.name}) "
                  f"failed in scope {self.path!r}")
        if self.propagate == "siblings":
            self.cancel(reason=reason)
        elif self.propagate == "ancestors":
            top = self
            while top.parent is not None:
                top = top.parent
            top.cancel(reason=reason)
