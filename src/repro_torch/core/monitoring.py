"""Hierarchical monitoring system (paper §IV) — the *streaming* half of the
proactive resilience plane.

Components:

* :class:`MonitoringDatabase` — the centralized monitoring database that
  consolidates task events, failure reports, heartbeats, resource profiles
  and placement history, and answers the queries the resilience module
  needs.  Since the proactive refactor the database no longer hoards raw
  append-only lists: observations stream into bounded ring buffers and into
  *online* per-task-template profiles (:class:`StreamingStats`, Welford
  mean/variance plus a bounded-sample p95) keyed overall, by node and by
  pool, and into per-node health trends (:class:`NodeHealth`: heartbeat
  jitter, memory-growth slope).  The query side — ``expected_duration``,
  ``node_health``, ``duration_stats`` — is what the
  :class:`~repro.core.proactive.ProactiveSentinel`, the straggler watcher,
  the training supervisor's shard sizing and the serve driver's replica
  health gate consume.
* :class:`Radio` — the communication radio.  :class:`InProcRadio` delivers
  messages in-process; :class:`TCPRadio`/:class:`TCPRadioServer` implement
  the paper's TCP transport (JSON lines over a socket) and are exercised by
  tests on localhost.  Both present the same ``send`` interface, so agents
  are transport-agnostic, mirroring the paper's modular database backends
  (local DB / cloud DB / Octopus event fabric).
* :class:`TaskMonitoringAgent` — per-node agent sampling resource usage of
  the running workers (psutil-based, as §VI-B) plus simulated node state.
* :class:`SystemMonitoringAgent` — heartbeat emitter for any component.

Memory bounds: every store (task events per task, system events, failure
reports, resource profiles per node, heartbeat-interval samples) is a ring
capped at ``retention`` entries; streaming profiles are O(1) per key.
"""
from __future__ import annotations

import json
import math
import socket
import socketserver
import threading
from collections import defaultdict, deque
from dataclasses import asdict, dataclass, field, is_dataclass
from typing import Any

try:
    import psutil  # noqa: F401
    _HAS_PSUTIL = True
except Exception:  # pragma: no cover
    _HAS_PSUTIL = False

from repro_torch.core.failures import FailureReport
from repro_torch.engine.events import REAL_CLOCK


# --------------------------------------------------------------------------
# Radio transports
# --------------------------------------------------------------------------


class Radio:
    def send(self, message: dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError


class InProcRadio(Radio):
    """Direct-dispatch radio (default for the simulated cluster)."""

    def __init__(self, db: "MonitoringDatabase"):
        self.db = db

    def send(self, message: dict[str, Any]) -> None:
        self.db.ingest(message)


class TCPRadioServer:
    """JSON-lines-over-TCP sink feeding a MonitoringDatabase (paper §VI-B)."""

    def __init__(self, db: "MonitoringDatabase", host: str = "127.0.0.1", port: int = 0):
        self.db = db
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        outer.db.ingest(json.loads(line.decode()))
                    except Exception:  # noqa: BLE001 - malformed msg dropped
                        pass

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="radio-server")

    def start(self) -> "TCPRadioServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class TCPRadio(Radio):
    def __init__(self, address: tuple[str, int]):
        self.address = address
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.address, timeout=2.0)
        return self._sock

    def send(self, message: dict[str, Any]) -> None:
        data = (json.dumps(message) + "\n").encode()
        with self._lock:
            try:
                self._connect().sendall(data)
            except OSError:
                self._sock = None
                self._connect().sendall(data)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


# --------------------------------------------------------------------------
# Streaming statistics
# --------------------------------------------------------------------------


class StreamingStats:
    """Online mean/variance (Welford) plus a bounded-sample p95 estimate.

    O(1) per observation, O(``sample_cap``) memory: the exact quantile of
    the last ``sample_cap`` observations stands in for the stream p95 —
    recency is a feature here (node speed and task mix drift).
    """

    __slots__ = ("n", "_mean", "_m2", "_min", "_max", "_samples", "_sorted")

    def __init__(self, sample_cap: int = 64) -> None:
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: deque[float] = deque(maxlen=sample_cap)
        # sorted view of _samples, rebuilt lazily — quantile() is on the
        # straggler watcher's periodic path, so it must not re-sort unless
        # a new observation arrived
        self._sorted: list[float] | None = None

    def push(self, x: float) -> None:
        x = float(x)
        self.n += 1
        d = x - self._mean
        self._mean += d / self.n
        self._m2 += d * (x - self._mean)
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        self._samples.append(x)
        self._sorted = None

    @property
    def mean(self) -> float:
        return self._mean if self.n else 0.0

    @property
    def var(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    @property
    def min(self) -> float:
        return self._min if self.n else 0.0

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    def quantile(self, q: float) -> float:
        """Quantile over the retained sample window (0 if empty)."""
        if not self._samples:
            return 0.0
        xs = self._sorted
        if xs is None:
            xs = self._sorted = sorted(self._samples)
        idx = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
        return xs[idx]

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    def snapshot(self) -> dict[str, float]:
        return {"n": self.n, "mean": self.mean, "std": self.std,
                "min": self.min, "max": self.max, "p95": self.p95}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<StreamingStats n={self.n} mean={self.mean:.4g} "
                f"std={self.std:.4g} p95={self.p95:.4g}>")


@dataclass
class TemplateProfile:
    """Streaming per-task-template profile: duration and memory."""

    duration: StreamingStats = field(default_factory=StreamingStats)
    memory_gb: StreamingStats = field(default_factory=StreamingStats)


@dataclass
class NodeHealth:
    """Point-in-time health trend of one node (query-side snapshot)."""

    node: str
    last_heartbeat: float = 0.0          # wall-clock ts of last beat (0 = never)
    heartbeat_mean_interval: float = 0.0
    heartbeat_jitter: float = 0.0        # std of inter-heartbeat intervals
    heartbeat_samples: int = 0
    mem_in_use_gb: float = 0.0
    mem_capacity_gb: float = 0.0
    mem_slope_gb_s: float = 0.0          # least-squares slope of recent samples
    profile_samples: int = 0

    def silent_for(self, now: float | None = None) -> float:
        if not self.last_heartbeat:
            return 0.0
        return max(0.0, (now if now is not None else REAL_CLOCK.time()) - self.last_heartbeat)

    def projected_mem_gb(self, horizon_s: float) -> float:
        """Memory in use projected ``horizon_s`` ahead along the trend."""
        return self.mem_in_use_gb + max(self.mem_slope_gb_s, 0.0) * horizon_s

    def trending_oom(self, horizon_s: float) -> bool:
        return (self.mem_capacity_gb > 0 and self.profile_samples >= 3
                and self.mem_slope_gb_s > 0
                and self.projected_mem_gb(horizon_s) > self.mem_capacity_gb)


# --------------------------------------------------------------------------
# Centralized monitoring database
# --------------------------------------------------------------------------


@dataclass
class PlacementStats:
    successes: int = 0
    failures: int = 0
    # accumulated wall time of *successful* attempts, for the
    # HistoryAwareScheduler's "historically fast node" query
    duration_sum: float = 0.0
    duration_n: int = 0

    @property
    def total(self) -> int:
        return self.successes + self.failures

    @property
    def success_rate(self) -> float:
        return self.successes / self.total if self.total else 0.0

    @property
    def avg_duration(self) -> float:
        """Mean successful-attempt duration (0.0 = no timed observations)."""
        return self.duration_sum / self.duration_n if self.duration_n else 0.0


class MonitoringDatabase:
    """Thread-safe centralized store + query API (paper §IV).

    ``retention`` bounds every ring store (events, failures, per-node
    profile samples); streaming profiles are O(1) per (template, node/pool).
    """

    def __init__(self, retention: int = 512, *, clock: Any = None,
                 keep_event_log: bool = False) -> None:
        if retention < 1:
            raise ValueError(f"retention must be >= 1, got {retention}")
        self.retention = retention
        # injected time source (repro.engine.events.Clock); every stored
        # timestamp goes through it so a virtual-clock engine produces
        # virtual-time (and therefore deterministic) monitoring data
        self.clock = clock
        self._time = clock.time if clock is not None else REAL_CLOCK.time
        # optional global ordered log of every task/system event — the
        # deterministic-simulation plane's *event trace*.  Unbounded, so
        # only enabled for finite scenario runs.
        self.event_log: list[dict[str, Any]] | None = ([] if keep_event_log
                                                       else None)
        self._lock = threading.RLock()
        self.task_events: dict[str, deque[dict[str, Any]]] = defaultdict(
            lambda: deque(maxlen=retention))
        self.system_events: deque[dict[str, Any]] = deque(maxlen=retention)
        self.failures: deque[FailureReport] = deque(maxlen=retention)
        self._heartbeats: dict[str, float] = {}
        self._hb_intervals: dict[str, StreamingStats] = defaultdict(
            lambda: StreamingStats(sample_cap=32))
        self.resource_profiles: dict[str, deque[dict[str, float]]] = defaultdict(
            lambda: deque(maxlen=retention))
        # streaming per-template profiles: overall + per-node + per-pool
        self._profiles: dict[str, TemplateProfile] = defaultdict(TemplateProfile)
        self._node_profiles: dict[tuple[str, str], TemplateProfile] = defaultdict(
            TemplateProfile)
        self._pool_profiles: dict[tuple[str, str], TemplateProfile] = defaultdict(
            TemplateProfile)
        # placement history keyed by task *name* (template), then node/pool
        self._node_history: dict[str, dict[str, PlacementStats]] = defaultdict(
            lambda: defaultdict(PlacementStats))
        self._pool_history: dict[str, dict[str, PlacementStats]] = defaultdict(
            lambda: defaultdict(PlacementStats))
        # named scalar gauges (serving-plane queue depth, slot occupancy):
        # streaming stats for the long view + a timestamped ring of recent
        # samples for trend queries ("has the queue grown for K ticks?")
        self._gauges: dict[str, StreamingStats] = defaultdict(
            lambda: StreamingStats(sample_cap=64))
        self._gauge_rings: dict[str, deque[tuple[float, float]]] = defaultdict(
            lambda: deque(maxlen=retention))

    # -- ingest (radio entry point) ----------------------------------------
    def ingest(self, message: dict[str, Any]) -> None:
        kind = message.get("kind")
        if kind == "heartbeat":
            self.heartbeat(message["node"], message.get("time", self._time()))
        elif kind == "task_event":
            self.record_task_event(message["task_id"], message["event"],
                                   **message.get("data", {}))
        elif kind == "resource_profile":
            self.record_resource_profile(message["node"], message.get("profile", {}))
        elif kind == "system_event":
            self.record_system_event(message["event"], **message.get("data", {}))
        elif kind == "placement":
            self.record_task_placement(message["task_name"], message["node"],
                                       message["pool"], ok=message["ok"],
                                       duration=message.get("duration"),
                                       memory_gb=message.get("memory_gb"))
        elif kind == "failure":
            # full-fidelity round trip: everything serialize_report ships is
            # preserved so a TCP-radio report equals an in-proc one
            d = message.get("report", {})
            self.report_failure(FailureReport(
                task_id=d.get("task_id"), exception=None,
                exception_type=d.get("exception_type", ""),
                message=d.get("message", ""), node=d.get("node"),
                pool=d.get("pool"), worker=d.get("worker"),
                resource_profile=dict(d.get("resource_profile") or {}),
                requirements=dict(d.get("requirements") or {}),
                retry_count=int(d.get("retry_count", 0)),
                timestamp=float(d.get("timestamp", 0.0)),
                log_tail=list(d.get("log_tail") or [])))

    # -- writers -----------------------------------------------------------
    def heartbeat(self, node: str, ts: float) -> None:
        with self._lock:
            last = self._heartbeats.get(node)
            if last is not None and ts > last:
                self._hb_intervals[node].push(ts - last)
            self._heartbeats[node] = ts

    def record_task_event(self, task_id: str, event: str, **data: Any) -> None:
        with self._lock:
            entry = {"event": event, "time": self._time(), **data}
            self.task_events[task_id].append(entry)
            if self.event_log is not None:
                self.event_log.append({"scope": "task", "task_id": task_id,
                                       **entry})

    def record_system_event(self, event: str, **data: Any) -> None:
        with self._lock:
            entry = {"event": event, "time": self._time(), **data}
            self.system_events.append(entry)
            if self.event_log is not None:
                self.event_log.append({"scope": "system", **entry})

    def event_sequence(self) -> list[tuple[str, str]]:
        """Ordered ``(scope_class, event)`` pairs from the event log.

        The raw material of trace n-gram coverage
        (:mod:`repro.sim.coverage`): task scopes collapse to the literal
        ``"task"`` — event *kinds* and their order define an engine
        state, task identities are just scenario size.  Requires
        ``keep_event_log=True``.
        """
        if self.event_log is None:
            raise ValueError("monitor was not built with keep_event_log=True")
        with self._lock:
            return [("system" if e["scope"] == "system" else "task",
                     e["event"]) for e in self.event_log]

    def record_resource_profile(self, node: str, profile: dict[str, float]) -> None:
        with self._lock:
            self.resource_profiles[node].append({"time": self._time(), **profile})

    def record_task_placement(self, task_name: str, node: str, pool: str | None,
                              *, ok: bool, duration: float | None = None,
                              memory_gb: float | None = None) -> None:
        with self._lock:
            ns = self._node_history[task_name][node]
            ps = self._pool_history[task_name][pool or "?"]
            if ok:
                ns.successes += 1
                ps.successes += 1
                if duration is not None and duration > 0:
                    for s in (ns, ps):
                        s.duration_sum += duration
                        s.duration_n += 1
                    for prof in (self._profiles[task_name],
                                 self._node_profiles[(task_name, node)],
                                 self._pool_profiles[(task_name, pool or "?")]):
                        prof.duration.push(duration)
                if memory_gb is not None and memory_gb > 0:
                    for prof in (self._profiles[task_name],
                                 self._node_profiles[(task_name, node)],
                                 self._pool_profiles[(task_name, pool or "?")]):
                        prof.memory_gb.push(memory_gb)
            else:
                ns.failures += 1
                ps.failures += 1

    def report_failure(self, report: FailureReport) -> None:
        with self._lock:
            self.failures.append(report)

    def record_gauge(self, name: str, value: float) -> None:
        """Observe one sample of a named scalar gauge (queue depth, slot
        occupancy, live replicas).  O(1); ring-bounded like every store."""
        with self._lock:
            value = float(value)
            self._gauges[name].push(value)
            self._gauge_rings[name].append((self._time(), value))

    # -- queries -------------------------------------------------------------
    def last_heartbeats(self) -> dict[str, float]:
        with self._lock:
            return dict(self._heartbeats)

    def node_history(self, task_name: str) -> dict[str, PlacementStats]:
        with self._lock:
            return {k: PlacementStats(v.successes, v.failures,
                                      v.duration_sum, v.duration_n)
                    for k, v in self._node_history[task_name].items()}

    def pool_history(self, task_name: str) -> dict[str, PlacementStats]:
        with self._lock:
            return {k: PlacementStats(v.successes, v.failures,
                                      v.duration_sum, v.duration_n)
                    for k, v in self._pool_history[task_name].items()}

    def best_historical_node(self, task_name: str,
                             exclude: set[str] = frozenset()) -> str | None:
        """Retry rung 3: where has this task succeeded most often?"""
        hist = self.node_history(task_name)
        best, best_score = None, 0
        for node, stats in hist.items():
            if node in exclude:
                continue
            if stats.successes > best_score:
                best, best_score = node, stats.successes
        return best

    def latest_profile(self, node: str) -> dict[str, float] | None:
        with self._lock:
            rows = self.resource_profiles.get(node)
            return dict(rows[-1]) if rows else None

    def failures_for(self, task_id: str) -> list[FailureReport]:
        with self._lock:
            return [f for f in self.failures if f.task_id == task_id]

    def events_for(self, task_id: str) -> list[dict[str, Any]]:
        with self._lock:
            return list(self.task_events[task_id])

    # -- streaming-profile queries (proactive plane) -----------------------
    def duration_stats(self, task_name: str, *, node: str | None = None,
                       pool: str | None = None) -> StreamingStats | None:
        """Streaming duration profile of a task template (None = no data).

        ``node``/``pool`` narrow the profile to one placement key; at most
        one of the two may be given.
        """
        with self._lock:
            if node is not None:
                prof = self._node_profiles.get((task_name, node))
            elif pool is not None:
                prof = self._pool_profiles.get((task_name, pool))
            else:
                prof = self._profiles.get(task_name)
            return prof.duration if prof is not None and prof.duration.n else None

    def memory_stats(self, task_name: str, *, node: str | None = None,
                     pool: str | None = None) -> StreamingStats | None:
        with self._lock:
            if node is not None:
                prof = self._node_profiles.get((task_name, node))
            elif pool is not None:
                prof = self._pool_profiles.get((task_name, pool))
            else:
                prof = self._profiles.get(task_name)
            return prof.memory_gb if prof is not None and prof.memory_gb.n else None

    def expected_duration(self, task_name: str, *, node: str | None = None,
                          min_samples: int = 3) -> float:
        """Profile-derived duration bound for straggler detection.

        Returns the p95 of observed successful durations (0.0 when fewer
        than ``min_samples`` observations exist) — the dynamic replacement
        for the static user-supplied ``est_duration_s``.
        """
        stats = self.duration_stats(task_name, node=node)
        if stats is None or stats.n < min_samples:
            return 0.0
        return stats.p95

    def gauge_stats(self, name: str) -> StreamingStats | None:
        """Streaming profile of a named gauge (None = never observed)."""
        with self._lock:
            stats = self._gauges.get(name)
            return stats if stats is not None and stats.n else None

    def recent_gauges(self, name: str, k: int = 16) -> list[tuple[float, float]]:
        """Last ``k`` (timestamp, value) samples of a gauge, oldest first.

        The serving autoscaler's trend query: "has the queue depth stayed
        above threshold for the last K observations?" reads this instead
        of keeping private per-policy counters, so any policy (or a test)
        can audit the same evidence the scaling decision used.
        """
        with self._lock:
            ring = self._gauge_rings.get(name)
            if not ring:
                return []
            return list(ring)[-k:]

    def node_health(self, node: str) -> NodeHealth:
        """Heartbeat-trend + memory-trend snapshot for one node."""
        with self._lock:
            h = NodeHealth(node=node,
                           last_heartbeat=self._heartbeats.get(node, 0.0))
            hb = self._hb_intervals.get(node)
            if hb is not None and hb.n:
                h.heartbeat_mean_interval = hb.mean
                h.heartbeat_jitter = hb.std
                h.heartbeat_samples = hb.n
            rows = self.resource_profiles.get(node)
            if rows:
                recent = list(rows)[-32:]
                mem = [(r["time"], r.get("sim_mem_in_use_gb", 0.0))
                       for r in recent]
                h.mem_in_use_gb = mem[-1][1]
                h.mem_capacity_gb = recent[-1].get("sim_mem_capacity_gb", 0.0)
                h.profile_samples = len(mem)
                if len(mem) >= 3:
                    t0 = mem[0][0]
                    xs = [t - t0 for t, _ in mem]
                    ys = [m for _, m in mem]
                    n = len(xs)
                    mx = sum(xs) / n
                    my = sum(ys) / n
                    denom = sum((x - mx) ** 2 for x in xs)
                    if denom > 1e-12:
                        h.mem_slope_gb_s = sum(
                            (x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
            return h

    def all_node_health(self) -> dict[str, NodeHealth]:
        with self._lock:
            nodes = set(self._heartbeats) | set(self.resource_profiles)
        return {n: self.node_health(n) for n in nodes}


# --------------------------------------------------------------------------
# Agents
# --------------------------------------------------------------------------


class SystemMonitoringAgent:
    """Heartbeat emitter for an arbitrary component (paper §IV)."""

    def __init__(self, component: str, radio: Radio, period: float = 0.05,
                 clock: Any = None):
        self.component = component
        self.radio = radio
        self.period = period
        # injected time source for heartbeat stamps (real clock by default)
        self.clock = clock if clock is not None else REAL_CLOCK
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"sysmon-{component}")

    def start(self) -> "SystemMonitoringAgent":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.radio.send({"kind": "heartbeat", "node": self.component,
                             "time": self.clock.time()})
            # Event.wait, not a raw sleep: stop() interrupts mid-period
            self._stop.wait(self.period)

    def stop(self) -> None:
        self._stop.set()


class TaskMonitoringAgent:
    """Per-node resource-profile sampler (psutil-based, paper §VI-B).

    Samples the hosting process's CPU/RSS via psutil (real measurements)
    and merges simulated node state (capacity, simulated in-use memory),
    shipping profiles over the radio.
    """

    def __init__(self, node: Any, radio: Radio, period: float = 0.1):
        self.node = node
        self.radio = radio
        self.period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"taskmon-{node.name}")
        self._proc = psutil.Process() if _HAS_PSUTIL else None

    def sample(self) -> dict[str, float]:
        prof: dict[str, float] = {
            "sim_mem_in_use_gb": float(self.node.mem_in_use_gb),
            "sim_mem_capacity_gb": float(self.node.memory_gb),
            "sim_healthy": float(self.node.healthy),
            "sim_queue_depth": float(self.node.task_queue.qsize()),
            "sim_alive_workers": float(sum(1 for w in self.node.workers if w.alive)),
        }
        if self._proc is not None:
            try:
                prof["proc_rss_gb"] = self._proc.memory_info().rss / 2**30
                prof["proc_cpu_pct"] = self._proc.cpu_percent(interval=None)
                prof["proc_open_files"] = float(len(self._proc.open_files()))
            except Exception:  # noqa: BLE001
                pass
        return prof

    def start(self) -> "TaskMonitoringAgent":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.radio.send({"kind": "resource_profile", "node": self.node.name,
                             "profile": self.sample()})
            self._stop.wait(self.period)

    def stop(self) -> None:
        self._stop.set()


def serialize_report(report: FailureReport) -> dict[str, Any]:
    """JSON-safe rendering of a FailureReport for radio shipping."""
    d = {k: v for k, v in asdict(report).items() if k != "exception"}
    if is_dataclass(d.get("requirements")):
        d["requirements"] = asdict(d["requirements"])
    return d
