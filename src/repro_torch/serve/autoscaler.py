"""Replica autoscaling as a resilience policy.

Scaling is a *policy decision*, so it rides the same middleware protocol
as retries and admission: :class:`ReplicaAutoscaler` is a
:class:`~repro.engine.policies.ResiliencePolicy` whose ``on_tick`` hook
reads the monitoring database's ``serve.queue_depth`` gauge trend (the
driver records one sample per tick) and grows or shrinks the serve pool
through the driver's ``add_replica`` / ``remove_replica`` plumbing.

Signals, deliberately simple and observable:

* **grow** — the queue has held above ``grow_queue_per_slot`` requests
  per live decode slot for ``patience`` consecutive gauge samples
  (sustained backlog, not a blip), and the pool is below
  ``max_replicas``.  One replica per decision, followed by a
  ``cooldown_ticks`` quiet period (default = ``patience``) so the next
  decision only ever reads gauge samples taken *after* the last one —
  scaling reacts at tick cadence but never oscillates step-to-step.
* **shrink** — the queue has been empty and at least one replica fully
  idle for ``idle_ticks`` consecutive ticks, and the pool is above
  ``min_replicas``.  Only an idle replica is retired (no in-flight
  request is ever evicted by scale-down).
* **replace** — live replicas dropped below ``min_replicas`` (chaos
  kill, denylist): grow immediately, no patience, because this is
  capacity *repair* rather than load-following.

Every decision is recorded as an ``autoscale_grow`` / ``autoscale_shrink``
system event, so scaling shows up in canonical traces and the chaos
benchmark can assert on it deterministically.
"""
from __future__ import annotations

from typing import Any

from repro_torch.engine.policies import ResiliencePolicy
from repro_torch.engine.retry_api import SchedulingContext

#: gauge the serving driver samples once per policy tick
QUEUE_DEPTH_GAUGE = "serve.queue_depth"


class ReplicaAutoscaler(ResiliencePolicy):
    """Grow/shrink the serve pool from queue-depth and idleness trends."""

    serve_plane_aware = True

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 8,
                 grow_queue_per_slot: float = 1.0, patience: int = 3,
                 idle_ticks: int = 5, cooldown_ticks: int | None = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.grow_queue_per_slot = grow_queue_per_slot
        self.patience = patience
        self.idle_ticks = idle_ticks
        # post-decision cooldown: the queue-depth gauge window still holds
        # pre-decision samples on the tick after a scale action, so acting
        # again immediately would react to a world that no longer exists
        # (the documented "never oscillating step-to-step" contract).
        # Defaults to `patience` — exactly long enough for the window to
        # refill with post-decision samples.
        self.cooldown_ticks = patience if cooldown_ticks is None \
            else cooldown_ticks
        self.plane: Any = None
        self._idle_streak = 0
        self._cooldown = 0
        self.grown = 0
        self.shrunk = 0

    def bind(self, plane: Any) -> None:
        self.plane = plane

    def unbind(self) -> None:
        self.plane = None

    # ------------------------------------------------------------------ #
    def on_tick(self, ctx: SchedulingContext) -> None:
        plane = self.plane
        if plane is None:
            return
        live = plane.live_replicas()
        n_live = len(live)

        # capacity repair: below the floor (replica loss) -> grow now
        # (repair ignores cooldown — availability beats smoothing — but
        # arms it, so the next *load-following* decision waits out the
        # stale gauge window)
        if n_live < self.min_replicas:
            if plane.add_replica(reason="below min_replicas") is not None:
                self.grown += 1
            self._idle_streak = 0
            self._cooldown = self.cooldown_ticks
            return

        # cooling down after a scale action: the gauge window still shows
        # the pre-decision world; skip load-following until it refills
        if self._cooldown > 0:
            self._cooldown -= 1
            self._idle_streak = 0
            return

        # sustained backlog -> grow
        if n_live < self.max_replicas and ctx.monitor is not None:
            recent = ctx.monitor.recent_gauges(QUEUE_DEPTH_GAUGE,
                                               k=self.patience)
            slots = max(plane.total_slots(), 1)
            threshold = self.grow_queue_per_slot * slots
            if (len(recent) >= self.patience
                    and all(depth > threshold for _, depth in recent)):
                if plane.add_replica(reason="sustained backlog") is not None:
                    self.grown += 1
                self._idle_streak = 0
                self._cooldown = self.cooldown_ticks
                return

        # sustained idleness -> shrink one idle replica
        idle = [r for r in live if plane.replica_idle(r)]
        if plane.queue.depth() == 0 and idle and n_live > self.min_replicas:
            self._idle_streak += 1
            if self._idle_streak >= self.idle_ticks:
                if plane.remove_replica(idle[-1].name,
                                        reason="sustained idle"):
                    self.shrunk += 1
                self._idle_streak = 0
                self._cooldown = self.cooldown_ticks
        else:
            self._idle_streak = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<ReplicaAutoscaler [{self.min_replicas},"
                f"{self.max_replicas}]>")
