"""Virtual time for the serving plane's simulated decode backend.

Only the clock is ported so far (a copy of ``src/repro/sim/clock.py``);
the scenario DSL, harness and chaos search wait for ROADMAP.md,
'Next slices' item 6.
"""
from repro_torch.sim.clock import VirtualClock

__all__ = ["VirtualClock"]
