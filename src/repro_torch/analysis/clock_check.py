"""CLK: clock discipline — no ambient time or global randomness.

Byte-identical sim traces (the PR 4 contract: same seed => identical
event trace on every machine) require every timestamp in sim-reachable
code to flow through the injected :class:`~repro_torch.engine.events.Clock`
and every random draw through a seeded ``random.Random``.  One raw
``time.time()`` in a code path the sim plane exercises silently splits
real-run and sim-run behaviour.

Rules (monotonic *measurement* time — ``time.monotonic`` /
``time.perf_counter`` — is deliberately allowed: it never lands in a
trace and has no virtual-clock analog worth faking):

=======  =========================================================
CLK001   ``time.time()`` call — use ``clock.time()`` / ``ctx.now()``
CLK002   ``time.sleep()`` call — use ``clock.sleep()`` /
         ``Event.wait(timeout)`` / EventLoop scheduling
CLK003   naive ``datetime.now/utcnow/today`` — derive wall stamps
         from ``clock.time()``
CLK004   global ``random.*`` call — use a seeded ``random.Random``
CLK005   bare reference to ``time.time``/``time.sleep`` (e.g.
         ``default_factory=time.time``) — same fix as CLK001/2
=======  =========================================================
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.scan import Module, ScopedVisitor, canonical, import_aliases

_CALL_RULES = {
    "time.time": ("CLK001", "raw time.time() call",
                  "read the injected Clock: clock.time() / ctx.now() / REAL_CLOCK.time()"),
    "time.time_ns": ("CLK001", "raw time.time_ns() call",
                     "read the injected Clock: clock.time() / ctx.now()"),
    "time.sleep": ("CLK002", "raw time.sleep() call",
                   "clock.sleep(), Event.wait(timeout), or an EventLoop call_later"),
}

_DATETIME_BANNED = {
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

#: global-module random callables that are fine: constructing an owned,
#: seedable generator is the *fix*, not the violation
_RANDOM_ALLOWED = {"Random", "SystemRandom"}


class _ClockVisitor(ScopedVisitor):
    def __init__(self, mod: Module):
        super().__init__()
        self.mod = mod
        self.mod_alias, self.from_alias = import_aliases(mod.tree)
        self.findings: list[Finding] = []
        self._call_funcs: set[int] = set()  # ids of nodes used as call targets

    def _emit(self, node: ast.AST, rule: str, message: str, hint: str) -> None:
        self.findings.append(Finding(
            rule=rule, file=self.mod.rel, line=node.lineno,
            col=node.col_offset, symbol=self.symbol,
            message=message, hint=hint))

    def _canon(self, node: ast.AST) -> str | None:
        return canonical(node, self.mod_alias, self.from_alias)

    def visit_Call(self, node: ast.Call) -> None:
        self._call_funcs.add(id(node.func))
        canon = self._canon(node.func)
        if canon is not None:
            if canon in _CALL_RULES:
                rule, msg, hint = _CALL_RULES[canon]
                self._emit(node, rule, msg, hint)
            elif canon in _DATETIME_BANNED:
                self._emit(node, "CLK003",
                           f"naive wall-clock call {canon}()",
                           "derive wall stamps from clock.time() "
                           "(virtual clocks have a deterministic epoch)")
            elif (canon.startswith("random.") and canon.count(".") == 1
                    and canon.split(".")[1] not in _RANDOM_ALLOWED):
                self._emit(node, "CLK004",
                           f"global {canon}() draws from shared, unseeded state",
                           "draw from an owned seeded generator: rng = random.Random(seed)")
        self.generic_visit(node)

    def _visit_ref(self, node: ast.AST) -> None:
        # bare references (not call targets) to banned callables — the
        # `default_factory=time.time` pattern defers the violation to runtime
        if id(node) not in self._call_funcs and isinstance(node.ctx, ast.Load):
            canon = self._canon(node)
            if canon in _CALL_RULES:
                _, msg, hint = _CALL_RULES[canon]
                self._emit(node, "CLK005", f"reference to {canon} "
                           "(called later, outside clock control)", hint)
            elif canon in _DATETIME_BANNED:
                self._emit(node, "CLK005", f"reference to {canon}",
                           "derive wall stamps from clock.time()")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._visit_ref(node)

    def visit_Name(self, node: ast.Name) -> None:
        self._visit_ref(node)


def check_clock(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if not mod.sim_reachable:
            continue
        v = _ClockVisitor(mod)
        v.visit(mod.tree)
        findings += v.findings
    return findings
