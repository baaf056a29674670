"""Contract-enforcing static analysis for the WRATH engine.

The engine's resilience guarantees are *contract properties of the
runtime*: byte-identical sim traces require every timestamp to flow
through the injected :class:`~repro_torch.engine.events.Clock`; the real-time
response path requires policy hooks and future resolution to never run
under the DataFlowKernel lock; and the coverage-guided chaos search keys
its n-gram coverage off monitor-event name strings.  This package makes
those contracts machine-checked on every push instead of tribal
knowledge.

Run it like a linter::

    PYTHONPATH=src python -m repro_torch.analysis            # report findings
    PYTHONPATH=src python -m repro_torch.analysis --strict   # fail on non-baselined
    PYTHONPATH=src python -m repro_torch.analysis --update-registry
    PYTHONPATH=src python -m repro_torch.analysis --check-registry

Four checkers, ruff-style ``file:line:col CODE`` findings:

========  ===========================================================
CLK00x    clock discipline: raw ``time.time``/``time.sleep``/
          ``datetime.now``/global ``random.*`` in sim-reachable code
LCK00x    lock discipline: callbacks, blocking calls, and nested lock
          acquisitions reachable while a lock is held; lock-order cycles
EVT00x    event-schema registry: every monitor-event name literal must
          appear in the checked-in ``event_registry``
HOK00x    hook exception-safety: ``ResiliencePolicy`` hooks invoked
          outside the stack's degrade path, hooks that raise
========  ===========================================================

Intentional violations are waived in ``analysis_baseline.json`` with a
one-line justification each; ``--strict`` fails on anything else.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.scan import Module, find_modules

__all__ = ["Baseline", "Finding", "Module", "find_modules", "run_checks"]


def run_checks(modules: list[Module]) -> list[Finding]:
    """Run every checker over ``modules`` and return sorted findings."""
    from repro_torch.analysis.clock_check import check_clock
    from repro_torch.analysis.event_check import check_events
    from repro_torch.analysis.hook_check import check_hooks
    from repro_torch.analysis.lock_check import check_locks

    findings: list[Finding] = []
    findings += check_clock(modules)
    findings += check_locks(modules)
    findings += check_events(modules)
    findings += check_hooks(modules)
    return sorted(findings, key=lambda f: (f.file, f.line, f.col, f.rule))
