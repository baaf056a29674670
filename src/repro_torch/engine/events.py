"""Event-driven core: one time-ordered event queue for the whole engine.

Pre-refactor the DataFlowKernel mixed three concurrency mechanisms: a
``threading.Timer`` per delayed retry, a dedicated ``_watch_loop`` polling
thread for heartbeat/straggler checks, and inline dispatch on whichever
thread happened to complete a dependency.  This module replaces all three
with a single :class:`EventLoop`: a min-heap of timestamped events drained
by one daemon thread under one lock discipline.

* **dispatches** are ``call_soon`` events (serialized on the loop thread);
* **delayed retries** are ``call_later`` events (cancellable, no Timer
  thread per retry);
* **heartbeat and straggler checks** are ``period=``-rescheduling events
  instead of a sleep-poll thread.

Event callbacks must never block for long — they run on the single loop
thread.  Exceptions raised by a callback are swallowed (a watcher bug must
not kill the engine), mirroring the old watcher loop's contract.

Time is an injected :class:`Clock`.  The default :class:`RealClock` is the
historical behaviour (monotonic scheduling timebase, wall-clock stamps, a
consumer thread that sleeps between events).  A *virtual* clock — one whose
``virtual`` attribute is true, e.g. :class:`repro.sim.VirtualClock` — flips
the loop into deterministic inline mode: ``start()`` spawns no thread, and
:meth:`EventLoop.run_until` executes events on the calling thread, jumping
the clock instantly to each event's timestamp.  A "60-second" heartbeat
-loss scenario therefore executes in microseconds, and — because a single
thread executes every event in (timestamp, FIFO) order — identically on
every run.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable


class Clock:
    """Time source protocol for the engine.

    ``now()`` is the *scheduling* timebase (monotonic seconds) the event
    loop orders events by; ``time()`` is the wall-clock stamp used for
    bookkeeping (heartbeats, TTF, monitor events); ``wait(cond, timeout)``
    blocks the consumer until notified or until ``timeout`` of this
    clock's seconds elapsed; ``sleep(seconds)`` pauses the calling thread
    for that many clock seconds (virtual clocks just jump forward).
    ``virtual`` marks clocks whose time advances by decree rather than by
    the passage of real time.
    """

    virtual: bool = False

    def now(self) -> float:  # pragma: no cover - protocol
        raise NotImplementedError

    def time(self) -> float:  # pragma: no cover - protocol
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: float) -> None:
        """Block on ``cond`` (held) for up to ``timeout`` clock seconds."""
        raise NotImplementedError  # pragma: no cover - protocol

    def sleep(self, seconds: float) -> None:
        """Pause the calling thread for ``seconds`` of this clock's time."""
        raise NotImplementedError  # pragma: no cover - protocol


class RealClock(Clock):
    """Wall time: the engine's historical behaviour."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def wait(self, cond: threading.Condition, timeout: float) -> None:
        cond.wait(timeout=timeout)

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


#: Shared default clock — stateless, so one instance serves every engine.
REAL_CLOCK = RealClock()


class ScheduledEvent:
    """Handle for one scheduled callback; ``cancel()`` is race-safe."""

    __slots__ = ("when", "fn", "args", "name", "period", "cancelled")

    def __init__(self, when: float, fn: Callable[..., Any], args: tuple,
                 name: str, period: float | None):
        self.when = when
        self.fn = fn
        self.args = args
        self.name = name
        self.period = period       # not None => reschedules itself
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        kind = f"every {self.period}s" if self.period else f"at {self.when:.3f}"
        return f"<ScheduledEvent {self.name!r} {kind}>"


class EventLoop:
    """Single-threaded, time-ordered event queue.

    Thread-safe producers (``call_soon`` / ``call_later`` / periodic
    events may be scheduled from any thread, including from inside a
    running callback); single consumer thread executes events in
    timestamp order, FIFO among equal timestamps.

    With a virtual ``clock`` the consumer thread is replaced by
    :meth:`run_until`: the caller's thread drains the heap inline,
    advancing the clock to each event's timestamp — no waiting, no
    threads, fully deterministic.
    """

    def __init__(self, name: str = "engine-events",
                 on_error: Callable[[str, BaseException], Any] | None = None,
                 clock: Clock | None = None):
        self.clock = clock or REAL_CLOCK
        self._heap: list[tuple[float, int, ScheduledEvent]] = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._stopped = False
        self._thread: threading.Thread | None = None
        if not self.clock.virtual:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=name)
        # observability: how many events have executed, by name
        self.dispatched: dict[str, int] = {}
        # optional hook observing swallowed callback exceptions (the DFK
        # records them as system events so watcher bugs stay visible)
        self.on_error = on_error

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EventLoop":
        if self._thread is not None:
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop; pending events are dropped (daemon semantics,
        matching the old daemon Timer threads at shutdown)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # -- producers --------------------------------------------------------
    def call_at(self, when: float, fn: Callable[..., Any], *args: Any,
                name: str = "", period: float | None = None) -> ScheduledEvent:
        """Schedule at an absolute ``clock.now()`` timestamp.

        The loop runs on the clock's monotonic timebase so a wall-clock
        step (NTP) can neither stall heartbeat/straggler checks nor fire
        retries early — parity with the ``threading.Timer``/sleep-loop
        mechanisms this replaces.
        """
        ev = ScheduledEvent(when, fn, args, name or fn.__name__, period)
        with self._cond:
            if self._stopped:
                ev.cancelled = True
                return ev
            heap = self._heap
            # wakeup coalescing: the consumer only needs a nudge when the
            # new event preempts the head it is already sleeping toward
            # (or the heap was empty).  Equal-timestamp bursts — the
            # call_soon fan-out storm — enqueue silently: the consumer
            # wakes for the head and drains everything due.  Inline mode
            # (virtual clock) has no consumer thread to wake at all.
            preempts = not heap or ev.when < heap[0][0]
            heapq.heappush(heap, (ev.when, next(self._seq), ev))
            if preempts and self._thread is not None:
                self._cond.notify_all()
        return ev

    def call_later(self, delay: float, fn: Callable[..., Any], *args: Any,
                   name: str = "") -> ScheduledEvent:
        return self.call_at(self.clock.now() + max(delay, 0.0), fn, *args,
                            name=name)

    def call_soon(self, fn: Callable[..., Any], *args: Any,
                  name: str = "") -> ScheduledEvent:
        # stamped "now", not 0.0: a burst of soon-events must interleave
        # FIFO with already-due timers (heartbeat checks, due retries)
        # instead of starving them until the burst drains
        return self.call_at(self.clock.now(), fn, *args, name=name)

    def schedule_periodic(self, period: float, fn: Callable[..., Any],
                          *args: Any, name: str = "") -> ScheduledEvent:
        """Run ``fn`` every ``period`` seconds until cancelled/stopped."""
        return self.call_at(self.clock.now() + period, fn, *args,
                            name=name or fn.__name__, period=period)

    def pending(self) -> int:
        with self._cond:
            return sum(1 for _, _, ev in self._heap if not ev.cancelled)

    # -- inline consumer (virtual clocks) ---------------------------------
    def run_until(self, predicate: Callable[[], bool] | None = None, *,
                  deadline: float | None = None,
                  max_events: int = 1_000_000) -> int:
        """Execute pending events inline, advancing a *virtual* clock.

        Events run on the calling thread in (timestamp, FIFO) order, the
        clock jumping to each event's timestamp — wall-clock cost is the
        callbacks themselves.  Stops when ``predicate()`` turns true
        (checked between events), when the next event lies beyond
        ``deadline`` (absolute ``clock.now()`` timestamp; the clock is
        advanced *to* the deadline so relative waits compose), when the
        heap drains, when the loop is stopped, or after ``max_events``
        (runaway-periodic backstop).  Returns the number of events
        executed.
        """
        if not self.clock.virtual:
            raise RuntimeError("run_until() requires a virtual clock; "
                               "real clocks drain on the loop thread")
        executed = 0
        # land the clock on the deadline whenever the run exhausted
        # everything scheduled before it (next-event-beyond-deadline,
        # drained heap, stopped loop) — but not when the predicate or the
        # max_events backstop cut the run short with due events remaining
        land_on_deadline = deadline is not None
        while executed < max_events:
            if predicate is not None and predicate():
                land_on_deadline = False
                break
            with self._cond:
                if self._stopped or not self._heap:
                    break
                when = self._heap[0][0]
                if deadline is not None and when > deadline:
                    break
                _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.clock.advance_to(ev.when)  # type: ignore[attr-defined]
            self._execute(ev)
            executed += 1
        else:
            land_on_deadline = False
        if land_on_deadline:
            self.clock.advance_to(deadline)  # type: ignore[attr-defined]
        return executed

    # -- consumer ---------------------------------------------------------
    def _execute(self, ev: ScheduledEvent) -> None:
        try:
            ev.fn(*ev.args)
        except Exception as e:  # noqa: BLE001 - an event must not kill the loop
            if self.on_error is not None:
                try:
                    self.on_error(ev.name, e)
                except Exception:  # noqa: BLE001 - hook bugs stay contained
                    pass
        self.dispatched[ev.name] = self.dispatched.get(ev.name, 0) + 1
        if ev.period is not None and not ev.cancelled:
            with self._cond:
                if not self._stopped:
                    ev.when = self.clock.now() + ev.period
                    heapq.heappush(self._heap, (ev.when, next(self._seq), ev))
                    # no notify: _execute only ever runs on the consumer
                    # thread (or inline under a virtual clock) — both
                    # re-examine the heap right after this returns

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    delay = self._heap[0][0] - self.clock.now()
                    if delay <= 0:
                        break
                    self.clock.wait(self._cond, delay)
                if self._stopped:
                    return
                _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._execute(ev)
