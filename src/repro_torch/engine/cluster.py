"""Simulated heterogeneous cluster (Runtime + Environment layers).

A :class:`Cluster` is a set of :class:`ResourcePool`\\ s (Parsl executors map
1:1 onto pools); each pool holds :class:`Node`\\ s with *distinct* memory
capacities, package environments, ulimits, health and speed — the
heterogeneity that WRATH's hierarchical retry exploits (paper §VII-C).

Execution follows the pilot-job model (paper §II-A): starting a pool runs a
*node manager* per node which spawns worker threads; workers pull tasks
from the node queue and push results back.  Node managers heartbeat to the
monitoring system; a hardware shutdown silences the heartbeat and kills the
node's in-flight tasks, exactly the manifestation chain of §III-B.

Resource enforcement: before running a task the worker checks the task's
:class:`~repro.engine.task.ResourceSpec` against the node — missing
packages raise :class:`EnvironmentMismatchError` (the ImportError
manifestation), insufficient memory raises :class:`MemoryError` (the OOM
manifestation), exceeded ulimits raise :class:`UlimitExceededError`.  This
is how the paper's "200 GB task on a 192 GB node" scenario arises naturally
rather than being scripted.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.failures import (
    EnvironmentMismatchError,
    HardwareShutdownError,
    PilotJobInitError,
    UlimitExceededError,
    WorkerLostError,
)
from repro_torch.engine.events import REAL_CLOCK
from repro_torch.engine.task import TaskRecord, TaskState

# thread-local handle letting task code discover which node it runs on
# (used by ``simwork`` for speed-scaled sleeps, and by tests)
_current = threading.local()


def current_node() -> "Node | None":
    return getattr(_current, "node", None)


def current_worker() -> "Worker | None":
    return getattr(_current, "worker", None)


def simwork(seconds: float) -> None:
    """Sleep ``seconds`` of *nominal* work, scaled by the node's speed.

    A straggler node (speed < 1) takes proportionally longer — the hook used
    by straggler-mitigation tests and benchmarks.
    """
    node = current_node()
    speed = node.speed if node is not None else 1.0
    time.sleep(seconds / max(speed, 1e-6))


class _WorkerKilled(BaseException):
    """Internal control-flow signal: the injected failure killed the worker."""


def enforce_and_reserve(node: "Node", spec) -> float:
    """The environment-enforcement chain run at task pickup.

    Raises the matching Table III manifestation — hardware down, missing
    package (ImportError analog), exceeded ulimit, OOM — or reserves the
    task's memory on the node and returns the reserved GB (caller
    releases it when the task finishes).  Shared by the real
    :class:`Worker` and the simulation plane's ``SimExecutor`` so the two
    can never diverge on how failures manifest.
    """
    if not node.healthy:
        raise HardwareShutdownError(
            f"node {node.name} hardware is down", node=node.name)
    if spec.packages:
        # only build the sets when the spec actually declares packages —
        # a no-requirement task cannot be missing anything
        missing = set(spec.packages) - set(node.packages)
        if missing:
            raise EnvironmentMismatchError(
                f"No module named {sorted(missing)[0]!r} on {node.name}",
                missing_packages=tuple(sorted(missing)),
                node=node.name,
            )
    if spec.open_files > node.ulimit_files:
        raise UlimitExceededError(
            f"OSError: [Errno 24] Too many open files "
            f"(need {spec.open_files}, ulimit {node.ulimit_files})",
            node=node.name,
        )
    if not spec.memory_gb:
        # a zero-GB request can neither overcommit nor need releasing;
        # skip the reservation lock on the pickup hot path
        return 0.0
    with node._mem_lock:
        if node.mem_in_use_gb + spec.memory_gb > node.memory_gb:
            # the OS would OOM-kill: manifest as MemoryError
            raise MemoryError(
                f"cannot allocate {spec.memory_gb}GB on {node.name} "
                f"({node.mem_in_use_gb}GB in use of {node.memory_gb}GB)")
        node.mem_in_use_gb += spec.memory_gb
    return spec.memory_gb


def kill_current_worker(msg: str = "worker killed by injected failure") -> None:
    """Called from *inside* a task to simulate the worker process dying
    (Table III 'Worker-killed').  Raises a BaseException subclass so user
    ``except Exception`` blocks cannot swallow it, mirroring a SIGKILL."""
    raise _WorkerKilled(msg)


class RunQueue:
    """Per-node run queue: FIFO for the owning node, stealable at the tail.

    Replaces ``queue.Queue`` on :class:`Node` with the same blocking
    ``get`` / ``queue.Empty`` surface the workers use, plus the two
    operations the engine layers need that a ``queue.Queue`` cannot do
    without draining and re-queueing the whole backlog:

    * :meth:`steal_tail` — remove and return the *newest* record passing a
      predicate.  Work stealing takes from the tail, leaving the oldest
      entries to the owner: a stolen task is by construction one nobody
      has started, which is what keeps the recovery semantics of a
      migrated task identical to a freshly-placed one;
    * :meth:`remove` — pull one specific queued record (real
      cancellation) with a single O(n) scan, no drain/requeue churn;
    * O(1) :meth:`qsize` — the queue-depth half of the scheduler's
      incrementally-maintained load index.
    """

    __slots__ = ("_items", "_mutex", "_cond", "_waiting")

    def __init__(self) -> None:
        self._items: deque = deque()
        # hold the raw lock directly on the hot paths: `with self._mutex`
        # enters the C lock without the extra Condition.__enter__ frame,
        # while the condition (sharing the same lock) serves blocking get
        self._mutex = threading.Lock()
        self._cond = threading.Condition(self._mutex)
        # consumers currently blocked in get(); put() only pays for a
        # notify when somebody is actually waiting (the sim plane never
        # blocks, so its puts skip it every time)
        self._waiting = 0

    def put(self, item: "TaskRecord | None") -> None:
        with self._mutex:
            self._items.append(item)
            if self._waiting:
                self._cond.notify()

    def get(self, timeout: float | None = None) -> "TaskRecord | None":
        """Pop the oldest entry; raises ``queue.Empty`` on timeout."""
        with self._mutex:
            if not self._items:
                self._waiting += 1
                try:
                    if timeout is None:
                        while not self._items:
                            self._cond.wait()
                    else:
                        deadline = time.monotonic() + timeout
                        while not self._items:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise queue.Empty
                            self._cond.wait(remaining)
                finally:
                    self._waiting -= 1
            return self._items.popleft()

    def get_nowait(self) -> "TaskRecord | None":
        with self._mutex:
            if not self._items:
                raise queue.Empty
            return self._items.popleft()

    def steal_tail(self, stealable: Callable[["TaskRecord"], bool]
                   ) -> "TaskRecord | None":
        """Remove and return the newest record passing ``stealable``
        (poison pills are never stolen); ``None`` if nothing qualifies."""
        with self._mutex:
            items = self._items
            for i in range(len(items) - 1, -1, -1):
                rec = items[i]
                if rec is not None and stealable(rec):
                    del items[i]
                    return rec
        return None

    def remove(self, task_id: str) -> "TaskRecord | None":
        """Pull one specific queued record off (real cancellation)."""
        with self._mutex:
            items = self._items
            for i, rec in enumerate(items):
                if rec is not None and rec.task_id == task_id:
                    del items[i]
                    return rec
        return None

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items


@dataclass
class Node:
    """One compute node (Environment layer)."""

    name: str
    memory_gb: float = 192.0
    packages: frozenset[str] = frozenset({"numpy", "jax"})
    ulimit_files: int = 1024
    speed: float = 1.0           # relative execution speed (stragglers < 1)
    workers_per_node: int = 2
    healthy: bool = True

    # runtime state ------------------------------------------------------
    pool: "ResourcePool | None" = field(default=None, repr=False)
    task_queue: RunQueue = field(default_factory=RunQueue, repr=False)
    workers: list["Worker"] = field(default_factory=list, repr=False)
    manager: "NodeManager | None" = field(default=None, repr=False)
    mem_in_use_gb: float = 0.0
    # busy half of the O(1) load index: maintained by the pickup/release
    # paths (real and sim workers) instead of rescanning the worker list
    busy_workers: int = field(default=0, repr=False)
    _mem_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def satisfies(self, spec) -> tuple[bool, str]:
        """Static check: could this node *ever* run a task with ``spec``?"""
        missing = set(spec.packages) - set(self.packages)
        if missing:
            return False, f"missing packages {sorted(missing)}"
        if spec.memory_gb > self.memory_gb:
            return False, f"needs {spec.memory_gb}GB > capacity {self.memory_gb}GB"
        if spec.open_files > self.ulimit_files:
            return False, f"needs {spec.open_files} fds > ulimit {self.ulimit_files}"
        return True, ""

    def shutdown_hardware(self) -> None:
        """Simulate a hardware shutdown (Environment-layer failure)."""
        self.healthy = False

    def restore_hardware(self) -> None:
        self.healthy = True

    def adjust_busy(self, delta: int) -> None:
        """Maintain the busy-worker count of the load index (clamped so a
        double release can never drive the reported load negative)."""
        with self._mem_lock:
            self.busy_workers = max(0, self.busy_workers + delta)

    def remove_queued(self, task_id: str) -> TaskRecord | None:
        """Pull one queued (not yet picked up) record off this node's queue.

        The real-cancellation primitive of the proactive plane: a queued
        task can be preempted/cancelled without ever running.  Returns the
        removed record, or ``None`` if no queued record matches (e.g. a
        worker grabbed it first — callers fall back to the running-task
        path).
        """
        return self.task_queue.remove(task_id)


@dataclass
class ResourcePool:
    """A pool of nodes = one Parsl executor's resources."""

    name: str
    nodes: list[Node] = field(default_factory=list)

    def __post_init__(self) -> None:
        for n in self.nodes:
            n.pool = self

    def healthy_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.healthy]

    def add_node(self, node: Node) -> None:
        node.pool = self
        self.nodes.append(node)

    def remove_node(self, name: str) -> Node | None:
        """Elastic membership: detach a node from the pool (scheduling
        stops seeing it immediately).  Queued/running work on the node is
        the caller's problem — the DFK's leave path sweeps it through the
        normal failure routing before calling this."""
        for i, n in enumerate(self.nodes):
            if n.name == name:
                del self.nodes[i]
                n.pool = None
                return n
        return None


class Worker:
    """A worker process analog: one thread pulling tasks off the node queue."""

    _ids = 0

    def __init__(self, node: Node, on_result: Callable[[TaskRecord, Any, BaseException | None, "Worker"], None],
                 clock: Any = None):
        Worker._ids += 1
        self.worker_id = f"{node.name}/w{Worker._ids:04d}"
        self.node = node
        self.on_result = on_result
        # injected time source for attempt start/end stamps
        self.clock = clock if clock is not None else REAL_CLOCK
        self.alive = True
        self.busy = False  # True while executing a task (load metric input)
        self._thread = threading.Thread(target=self._loop, name=self.worker_id, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        _current.node = self.node
        _current.worker = self
        while self.alive:
            try:
                rec = self.node.task_queue.get(timeout=0.1)
            except queue.Empty:
                if not self.node.healthy:
                    self.alive = False
                    continue
                # idle with an empty queue: try to pull the newest queued
                # record off a loaded sibling (decentralized work stealing;
                # a no-op unless the executor enabled it)
                mgr = self.node.manager
                rec = mgr.try_steal() if mgr is not None else None
                if rec is None:
                    continue
            if rec is None:  # poison pill
                self.alive = False
                break
            if rec.cancel_requested:
                # cancelled while queued: drop without executing — the DFK
                # already resolved (or re-dispatched) the task
                continue
            self.busy = True
            self.node.adjust_busy(+1)
            try:
                self._run_one(rec)
            finally:
                self.busy = False
                self.node.adjust_busy(-1)

    # -- execution with environment enforcement -------------------------
    def _run_one(self, rec: TaskRecord) -> None:
        node = self.node
        spec = rec.effective_resources()
        rec.start_time = self.clock.time()
        # task-state lifecycle: the worker, not the executor, marks RUNNING —
        # the straggler watcher and node-loss sweep key off this transition.
        # READY is accepted too: under batched dispatch a worker can win the
        # race with the drain loop's SCHEDULED bookkeeping write.
        if rec.state in (TaskState.READY, TaskState.SCHEDULED,
                         TaskState.RETRYING):
            rec.state = TaskState.RUNNING
            if rec.on_running is not None:
                try:
                    rec.on_running(rec)
                except Exception:  # noqa: BLE001 - a policy bug must not kill the worker
                    pass
        err: BaseException | None = None
        result: Any = None
        try:
            reserved = enforce_and_reserve(node, spec)
            try:
                result = rec.fn(*rec.args, **rec.kwargs)
            finally:
                with node._mem_lock:
                    node.mem_in_use_gb -= reserved
        except _WorkerKilled as wk:
            # the "process" died: this worker stops pulling tasks
            self.alive = False
            err = WorkerLostError(str(wk), node=node.name, worker=self.worker_id)
        except BaseException as e:  # noqa: BLE001 - we must capture everything
            err = e
            err._wrath_traceback = traceback.format_exc()  # type: ignore[attr-defined]
        rec.end_time = self.clock.time()
        self.on_result(rec, result, err, self)


class NodeManager:
    """Pilot-job node manager: spawns workers and heartbeats (paper §VI-A)."""

    def __init__(self, node: Node, on_result, heartbeat: Callable[[str, float], None] | None,
                 heartbeat_period: float = 0.05, clock: Any = None,
                 steal_source: Callable[[Node], "TaskRecord | None"] | None = None):
        self.node = node
        self.on_result = on_result
        self.heartbeat = heartbeat
        self.heartbeat_period = heartbeat_period
        # executor-provided hook (thief_node) -> record: the idle-worker
        # steal path; None when work stealing is disabled
        self.steal_source = steal_source
        # heartbeat timestamps go through the engine clock so watchers
        # comparing "now - last beat" agree on the timebase
        self.clock = clock
        self._stop = threading.Event()
        self._hb_paused = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"hb-{node.name}", daemon=True)

    def start(self) -> None:
        if not self.node.healthy:
            raise PilotJobInitError(
                f"pilot job failed to initialize on {self.node.name}",
                node=self.node.name)
        for _ in range(self.node.workers_per_node):
            self.spawn_worker()
        self._hb_thread.start()

    def spawn_worker(self) -> Worker:
        w = Worker(self.node, self.on_result, clock=self.clock)
        self.node.workers.append(w)
        w.start()
        return w

    def alive_workers(self) -> list[Worker]:
        return [w for w in self.node.workers if w.alive]

    def restart_dead_workers(self) -> int:
        """WRATH 'restart failed component' action for lost workers."""
        n = 0
        self.node.workers = [w for w in self.node.workers if w.alive]
        while len(self.node.workers) < self.node.workers_per_node:
            self.spawn_worker()
            n += 1
        return n

    def cancel(self, task_id: str) -> TaskRecord | None:
        """Remove a queued task from this node (real cancellation path)."""
        return self.node.remove_queued(task_id)

    def try_steal(self) -> TaskRecord | None:
        """Ask the executor for a stolen record on behalf of this node."""
        if self.steal_source is None or not self.node.healthy:
            return None
        return self.steal_source(self.node)

    def pause_heartbeats(self) -> None:
        """Silence the heartbeat while workers keep running — the 'node
        trending toward silence' scenario the proactive drain detects."""
        self._hb_paused.set()

    def resume_heartbeats(self) -> None:
        self._hb_paused.clear()

    def _hb_loop(self) -> None:
        while not self._stop.is_set():
            if self.node.healthy:
                if self.heartbeat is not None and not self._hb_paused.is_set():
                    now = (self.clock if self.clock is not None else REAL_CLOCK).time()
                    self.heartbeat(self.node.name, now)
                # pilot-job managers track worker processes and respawn the
                # dead (tasks queued behind a killed worker must not orphan)
                self.restart_dead_workers()
            # Event.wait, not a raw sleep: stop() interrupts mid-period
            self._stop.wait(self.heartbeat_period)

    def stop(self) -> None:
        self._stop.set()
        for w in self.node.workers:
            w.alive = False
        # poison pills to unblock queue waits
        for _ in self.node.workers:
            self.node.task_queue.put(None)


class Cluster:
    """The full simulated machine: pools of heterogeneous nodes."""

    def __init__(self, pools: list[ResourcePool]):
        self.pools = {p.name: p for p in pools}
        if len(self.pools) != len(pools):
            raise ValueError("duplicate pool names")

    def pool(self, name: str) -> ResourcePool:
        return self.pools[name]

    def all_nodes(self) -> list[Node]:
        return [n for p in self.pools.values() for n in p.nodes]

    def find_node(self, name: str) -> Node | None:
        for n in self.all_nodes():
            if n.name == name:
                return n
        return None

    # convenience constructors -----------------------------------------
    @staticmethod
    def homogeneous(n_nodes: int = 4, *, pool_name: str = "default",
                    memory_gb: float = 192.0,
                    packages: frozenset[str] = frozenset({"numpy", "jax"}),
                    workers_per_node: int = 2) -> "Cluster":
        nodes = [Node(name=f"{pool_name}-n{i:03d}", memory_gb=memory_gb,
                      packages=packages, workers_per_node=workers_per_node)
                 for i in range(n_nodes)]
        return Cluster([ResourcePool(pool_name, nodes)])

    @staticmethod
    def paper_testbed(small_nodes: int = 4, big_nodes: int = 1, *,
                      with_pkg_pool: bool = False,
                      package: str = "scipy",
                      workers_per_node: int = 2) -> "Cluster":
        """The §VII-C two-executor setup: 192 GB nodes vs 6 TB nodes, and
        optionally a with-package vs without-package pool pair."""
        base_pkgs = frozenset({"numpy", "jax"})
        pools = [
            ResourcePool("small-mem", [
                Node(name=f"small-n{i:03d}", memory_gb=192.0, packages=base_pkgs,
                     workers_per_node=workers_per_node)
                for i in range(small_nodes)]),
            ResourcePool("big-mem", [
                Node(name=f"big-n{i:03d}", memory_gb=6144.0, packages=base_pkgs,
                     workers_per_node=workers_per_node)
                for i in range(big_nodes)]),
        ]
        if with_pkg_pool:
            pools = [
                ResourcePool("no-pkg", [
                    Node(name=f"nopkg-n{i:03d}", memory_gb=192.0,
                         packages=base_pkgs, workers_per_node=workers_per_node)
                    for i in range(small_nodes)]),
                ResourcePool("with-pkg", [
                    Node(name=f"pkg-n{i:03d}", memory_gb=192.0,
                         packages=base_pkgs | {package},
                         workers_per_node=workers_per_node)
                    for i in range(big_nodes)]),
            ]
        return Cluster(pools)
