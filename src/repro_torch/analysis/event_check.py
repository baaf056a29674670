"""EVT: the event-schema registry — monitor-event names are an API.

The chaos search's n-gram coverage (PR 9), the golden sim traces, and
every dashboard query key off monitor-event *name strings*.  A typo'd
name doesn't crash anything — it silently forks the schema: coverage
tokens stop matching, trace diffs churn, queries miss events.  This
checker extracts every name literal passed to ``record_task_event`` /
``record_system_event`` / ``record_gauge`` and validates it against the
checked-in :mod:`repro_torch.analysis.event_registry`.

=======  ==========================================================
EVT001   event/gauge name literal not in the registry (typo, or a
         new event — add it via ``--update-registry``)
EVT002   dynamic event name whose shape the registry cannot check
         (no registered prefix, not an if-else of literals, not an
         exempt plumbing function)
=======  ==========================================================

Recognized dynamic shapes: f-strings with a registered prefix
(``f"fault_{kind}"``), if-else of two literals (both validated), and
registered pass-through wrappers (``RequestQueue._event`` — its *call
sites* are validated instead).  ``MonitoringDatabase.ingest`` is the
radio deserializer and exempt by construction (its names were validated
at the sending site).
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.scan import Module, ScopedVisitor, terminal_name

#: recorder method -> (registry kind, positional index of the name arg)
RECORDERS = {
    "record_task_event": ("task", 1),
    "record_system_event": ("system", 0),
    "record_gauge": ("gauge", 0),
}

#: pass-through wrappers: method name -> (kind, name-arg index).  Calls
#: *to* a wrapper are validated like recorder calls; the non-literal
#: recorder call *inside* the wrapper body is exempt.
WRAPPERS = {
    "_event": ("system", 0),
}

#: f-string prefixes that name a registered event *family*; members are
#: closed sets elsewhere (sim fault kinds, proactive decision kinds)
KNOWN_PREFIXES = ("fault_", "proactive_")

#: functions whose dynamic recorder calls re-emit already-validated
#: names (deserializers / generic re-publishers)
EXEMPT_DYNAMIC = frozenset({
    ("core/monitoring.py", "MonitoringDatabase.ingest"),
})


def _load_registry() -> dict[str, frozenset[str]]:
    from repro_torch.analysis import event_registry as reg

    return {"task": reg.TASK_EVENTS, "system": reg.SYSTEM_EVENTS,
            "gauge": reg.GAUGES}


def _recorder_target(node: ast.Call) -> tuple[str, int, bool] | None:
    """(kind, name-arg index, is_wrapper) if this call emits an event."""
    name = terminal_name(node.func)
    if name in RECORDERS:
        kind, idx = RECORDERS[name]
        return kind, idx, False
    if name in WRAPPERS:
        kind, idx = WRAPPERS[name]
        return kind, idx, True
    return None


def _literal_names(arg: ast.AST) -> list[str] | None:
    """Extract the literal name(s), or None if the shape is dynamic."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if (isinstance(arg, ast.IfExp)
            and isinstance(arg.body, ast.Constant) and isinstance(arg.body.value, str)
            and isinstance(arg.orelse, ast.Constant) and isinstance(arg.orelse.value, str)):
        return [arg.body.value, arg.orelse.value]
    return None


def _fstring_prefix(arg: ast.AST) -> str | None:
    if (isinstance(arg, ast.JoinedStr) and arg.values
            and isinstance(arg.values[0], ast.Constant)
            and isinstance(arg.values[0].value, str)):
        return arg.values[0].value
    return None


class _EventVisitor(ScopedVisitor):
    def __init__(self, mod: Module, registry: dict[str, frozenset[str]] | None,
                 extract: dict[str, set[str]] | None):
        super().__init__()
        self.mod = mod
        self.registry = registry
        self.extract = extract
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        target = _recorder_target(node)
        if target is not None:
            kind, idx, is_wrapper = target
            inside_wrapper = any(part in WRAPPERS for part in self.symbol.split("."))
            exempt = ((self.mod.rel, self.symbol) in EXEMPT_DYNAMIC
                      or (not is_wrapper and inside_wrapper))
            if not exempt:
                self._check_name_arg(node, kind, idx)
        self.generic_visit(node)

    def _check_name_arg(self, node: ast.Call, kind: str, idx: int) -> None:
        if len(node.args) <= idx:
            return  # name passed by keyword / malformed — out of scope
        arg = node.args[idx]
        names = _literal_names(arg)
        if names is not None:
            for name in names:
                if self.extract is not None:
                    self.extract[kind].add(name)
                elif self.registry is not None and name not in self.registry[kind]:
                    self._emit(arg, "EVT001",
                               f"{kind} event name {name!r} is not in the registry",
                               "fix the typo, or register the new name: "
                               "python -m repro_torch.analysis --update-registry")
            return
        prefix = _fstring_prefix(arg)
        if prefix is not None:
            if any(prefix.startswith(p) for p in KNOWN_PREFIXES):
                return  # registered event family, e.g. f"fault_{kind}"
            if self.registry is not None:
                self._emit(arg, "EVT002",
                           f"f-string event prefix {prefix!r} is not a registered family",
                           f"registered prefixes: {', '.join(KNOWN_PREFIXES)}")
            return
        if self.registry is not None:
            self._emit(arg, "EVT002",
                       f"dynamic {kind} event name the registry cannot validate",
                       "use a literal, an if-else of literals, a registered "
                       "prefix family, or register the function as a wrapper")

    def _emit(self, node: ast.AST, rule: str, msg: str, hint: str) -> None:
        self.findings.append(Finding(
            rule=rule, file=self.mod.rel, line=node.lineno,
            col=node.col_offset, symbol=self.symbol, message=msg, hint=hint))


def check_events(modules: list[Module]) -> list[Finding]:
    registry = _load_registry()
    findings: list[Finding] = []
    for mod in modules:
        v = _EventVisitor(mod, registry, extract=None)
        v.visit(mod.tree)
        findings += v.findings
    return findings


def extract_registry(modules: list[Module]) -> dict[str, set[str]]:
    """Collect every literal event/gauge name emitted by ``modules``."""
    out: dict[str, set[str]] = {"task": set(), "system": set(), "gauge": set()}
    for mod in modules:
        v = _EventVisitor(mod, registry=None, extract=out)
        v.visit(mod.tree)
    return out


_REGISTRY_TEMPLATE = '''"""Checked-in registry of every monitor-event and gauge name.

GENERATED by ``python -m repro_torch.analysis --update-registry`` from the
name literals in ``src/repro_torch`` — edit code, not this file.  The chaos
search's coverage tokens and the golden sim traces key off these exact
strings; an unregistered name fails the build (EVT001), and CI checks
this file matches the code (``--check-registry``).
"""
from __future__ import annotations

TASK_EVENTS = frozenset({{
{task}
}})

SYSTEM_EVENTS = frozenset({{
{system}
}})

GAUGES = frozenset({{
{gauge}
}})

#: dynamic-name families (``f"fault_{{kind}}"`` …); members are closed
#: sets owned by the emitting module
PREFIXES = {prefixes!r}
'''


def render_registry(extracted: dict[str, set[str]]) -> str:
    def block(names: set[str]) -> str:
        return "\n".join(f"    {n!r}," for n in sorted(names))

    return _REGISTRY_TEMPLATE.format(
        task=block(extracted["task"]),
        system=block(extracted["system"]),
        gauge=block(extracted["gauge"]),
        prefixes=tuple(KNOWN_PREFIXES),
    )


def registry_path() -> Path:
    return Path(__file__).resolve().parent / "event_registry.py"


def registry_drift(modules: list[Module]) -> list[str]:
    """Human-readable diffs between the code and the committed registry
    (empty = in sync)."""
    current = _load_registry()
    extracted = extract_registry(modules)
    drift: list[str] = []
    for kind in ("task", "system", "gauge"):
        missing = sorted(extracted[kind] - current[kind])
        stale = sorted(current[kind] - extracted[kind])
        for name in missing:
            drift.append(f"{kind} event {name!r} emitted but not registered")
        for name in stale:
            drift.append(f"{kind} event {name!r} registered but never emitted")
    return drift
