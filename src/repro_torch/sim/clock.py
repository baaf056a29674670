"""Virtual time: the deterministic clock behind the simulation plane.

A :class:`VirtualClock` is a :class:`repro_torch.engine.events.Clock` whose time
advances only by decree — :meth:`advance_to` — never by the passage of
real time.  The :class:`~repro_torch.engine.events.EventLoop` drives it from
``run_until``: pop the next scheduled event, jump the clock to its
timestamp, execute.  A "60-second" heartbeat-loss scenario therefore
costs exactly the callbacks it runs, and two runs of the same scenario
see the same timestamps to the last bit.

``time()`` (the wall-clock stamp used for heartbeats, TTF and monitor
events) is ``epoch + now()``: a fixed, plausible-looking epoch keeps
virtual wall stamps positive and distinguishable from real ones while
staying deterministic.
"""
from __future__ import annotations

import threading

from repro_torch.engine.events import Clock


class VirtualClock(Clock):
    """Deterministic discrete-event clock (starts at virtual second 0)."""

    virtual = True

    #: fixed virtual epoch for wall-clock stamps (2023-11-14T22:13:20Z)
    EPOCH = 1_700_000_000.0

    def __init__(self, start: float = 0.0, epoch: float = EPOCH):
        self._now = float(start)
        self.epoch = float(epoch)

    # -- Clock protocol ---------------------------------------------------
    def now(self) -> float:
        return self._now

    def time(self) -> float:
        return self.epoch + self._now

    def wait(self, cond: threading.Condition, timeout: float) -> None:
        # only reachable if a *threaded* EventLoop is built on a virtual
        # clock — the loop refuses that combination, so waiting here would
        # mean a bug: fail loudly instead of hanging a test run
        raise RuntimeError("VirtualClock cannot wait; drive the loop with "
                           "EventLoop.run_until() instead")

    def sleep(self, seconds: float) -> None:
        # a virtual sleep is just a jump: no thread ever blocks on it
        self.advance(seconds)

    # -- virtual-time control ---------------------------------------------
    def advance_to(self, t: float) -> None:
        """Jump to virtual timestamp ``t`` (never backwards)."""
        if t > self._now:
            self._now = t

    def advance(self, dt: float) -> None:
        """Jump forward ``dt`` virtual seconds."""
        self.advance_to(self._now + dt)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<VirtualClock t={self._now:.6f}>"
