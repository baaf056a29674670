"""LCK: lock discipline — what may happen while a lock is held.

The DataFlowKernel's locking contract (``dfk.py``, "LOCKING
DISCIPLINE") says ``_lock`` guards bookkeeping *only*: policy hooks,
future resolution (``set_result``/``set_exception``), and anything that
can block must run outside it, or a policy callback that re-enters the
engine deadlocks the whole run.  PR 6 audited this by hand, once; this
checker re-audits on every push.

Mechanics: for every ``with <lock>:`` region we collect what happens
inside — directly, and transitively through an intra-module call graph
(``self.method()`` -> same class, ``func()`` -> same module; anything
else is a resolution boundary).  Conditions constructed over a lock
(``threading.Condition(self._lock)``) alias to that lock, so waiting on
the engine's shared condition is not a nested acquisition.

=======  ==========================================================
LCK001   user-facing callback (policy hook, validator,
         ``set_result``/``set_exception``, ``_resolve_stack``)
         reachable under a lock
LCK002   blocking call (``.result()``, thread ``.join()``, any
         ``sleep``) reachable under a lock
LCK003   nested acquisition of a *different* lock while one is held
LCK004   lock-order cycle across the scanned modules (deadlock risk)
=======  ==========================================================

``Condition.wait`` is exempt (it releases the lock it waits on).  The
call graph is an over-approximation: a finding means "a path the
analyzer cannot rule out", and intentional, ordered nestings are waived
in the baseline with their ordering argument.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.scan import Module, dotted, terminal_name

#: attribute/variable names that denote a lock-like object
_LOCK_NAME = re.compile(r"lock|mutex|cond|sem|_all_done", re.IGNORECASE)

#: user-facing callbacks: resilience-policy hooks, validators, and
#: future resolution — the things the DFK contract keeps outside locks
CALLBACK_NAMES = frozenset({
    "on_submit", "on_dispatch", "on_running", "on_failure", "on_result",
    "on_tick", "review_decision", "admit_request", "memo_lookup",
    "memo_commit", "memo_invalidate", "bind", "unbind", "validate",
    "set_result", "set_exception", "_resolve_stack",
})

#: call names that block the calling thread outright
_BLOCKING_NAMES = frozenset({"result", "sleep"})

_MAX_DEPTH = 8  # call-graph traversal bound (paths deeper are invisible)


@dataclass
class _FuncSummary:
    """Everything one function does, regardless of its own lock regions."""

    symbol: str
    callbacks: list[tuple[str, int]] = field(default_factory=list)
    blocking: list[tuple[str, int]] = field(default_factory=list)
    acquires: list[tuple[str, int]] = field(default_factory=list)
    calls: list[tuple[str, int]] = field(default_factory=list)  # resolvable keys


def _is_blocking_call(node: ast.Call) -> str | None:
    name = terminal_name(node.func)
    if name in _BLOCKING_NAMES:
        return name
    if name == "join" and isinstance(node.func, ast.Attribute):
        recv = dotted(node.func.value) or ""
        # str.join is ubiquitous; only thread-ish receivers block
        if re.search(r"thread|worker|proc", recv, re.IGNORECASE):
            return "join"
    return None


def _is_callback_call(node: ast.Call) -> str | None:
    name = terminal_name(node.func)
    return name if name in CALLBACK_NAMES else None


class _ModuleLocks:
    """Per-module lock model: aliases, function summaries, lock regions."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.cond_alias: dict[str, str] = {}   # lock-id -> aliased lock-id
        self.funcs: dict[str, _FuncSummary] = {}
        # (lock_id, region stmts, enclosing symbol, with-node) per region
        self.regions: list[tuple[str, list[ast.stmt], str, ast.With]] = []
        self._collect()

    # -- lock identity -------------------------------------------------
    def _lock_id(self, expr: ast.AST, cls: str | None) -> str | None:
        name = dotted(expr)
        if name is None:
            return None
        attr = name.split(".")[-1]
        if not _LOCK_NAME.search(attr):
            return None
        if name.startswith("self.") and cls:
            lid = f"{cls}.{name[len('self.'):]}"
        elif "." not in name:
            lid = f"<module>.{name}"
        else:
            lid = name
        return self.cond_alias.get(lid, lid)

    def _collect_cond_aliases(self) -> None:
        # self._all_done = threading.Condition(self._lock)  =>  alias
        for cls_node in ast.walk(self.mod.tree):
            if not isinstance(cls_node, ast.ClassDef):
                continue
            for node in ast.walk(cls_node):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.value, ast.Call)):
                    continue
                if terminal_name(node.value.func) != "Condition":
                    continue
                if not node.value.args:
                    continue
                tgt = dotted(node.targets[0])
                src = dotted(node.value.args[0])
                if tgt and src and tgt.startswith("self.") and src.startswith("self."):
                    self.cond_alias[f"{cls_node.name}.{tgt[5:]}"] = \
                        f"{cls_node.name}.{src[5:]}"

    # -- function summaries + lock regions ----------------------------
    def _collect(self) -> None:
        self._collect_cond_aliases()
        mod = self

        class V(ast.NodeVisitor):
            def __init__(self) -> None:
                self.cls: str | None = None
                self.func: _FuncSummary | None = None
                self.symbol = "<module>"

            def visit_ClassDef(self, node: ast.ClassDef) -> None:
                prev, self.cls = self.cls, node.name
                self.generic_visit(node)
                self.cls = prev

            def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
                prev_f, prev_s = self.func, self.symbol
                self.symbol = f"{self.cls}.{node.name}" if self.cls else node.name
                self.func = _FuncSummary(symbol=self.symbol)
                mod.funcs[self.symbol] = self.func
                self.generic_visit(node)
                self.func, self.symbol = prev_f, prev_s

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_With(self, node: ast.With) -> None:
                for item in node.items:
                    lid = mod._lock_id(item.context_expr, self.cls)
                    if lid is not None:
                        mod.regions.append((lid, node.body, self.symbol, node))
                        if self.func is not None:
                            self.func.acquires.append((lid, node.lineno))
                self.generic_visit(node)

            def visit_Call(self, node: ast.Call) -> None:
                if self.func is not None:
                    cb = _is_callback_call(node)
                    if cb:
                        self.func.callbacks.append((cb, node.lineno))
                    blk = _is_blocking_call(node)
                    if blk:
                        self.func.blocking.append((blk, node.lineno))
                    if terminal_name(node.func) == "acquire":
                        recv = node.func.value if isinstance(node.func, ast.Attribute) else None
                        lid = mod._lock_id(recv, self.cls) if recv is not None else None
                        if lid is not None:
                            self.func.acquires.append((lid, node.lineno))
                    key = self._resolve(node)
                    if key is not None:
                        self.func.calls.append((key, node.lineno))
                self.generic_visit(node)

            def _resolve(self, node: ast.Call) -> str | None:
                """Map a call to a same-module function summary key."""
                f = node.func
                if isinstance(f, ast.Attribute):
                    recv = dotted(f.value)
                    if recv == "self" and self.cls:
                        return f"{self.cls}.{f.attr}"
                    return None
                if isinstance(f, ast.Name):
                    return f.id
                return None

        V().visit(self.mod.tree)


def _region_scan(mod: _ModuleLocks, lock_id: str, body: list[ast.stmt],
                 symbol: str, cls: str | None,
                 findings: list[Finding], edges: dict[tuple[str, str], tuple[str, int, str]]) -> None:
    """Scan one held-lock region: direct violations + reachable ones."""
    rel = mod.mod.rel

    def emit(rule: str, line: int, msg: str, hint: str) -> None:
        findings.append(Finding(rule=rule, file=rel, line=line, col=0,
                                symbol=symbol, message=msg, hint=hint))

    direct_calls: list[tuple[str, int]] = []

    class R(ast.NodeVisitor):
        # stay lexical: nested defs run later, not under this lock
        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            return
        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def visit_With(self, node: ast.With) -> None:
            for item in node.items:
                lid = mod._lock_id(item.context_expr, cls)
                if lid is not None and lid != lock_id:
                    emit("LCK003", node.lineno,
                         f"acquires {lid} while holding {lock_id}",
                         "hold one lock at a time, or keep this ordering "
                         "global and baseline it with the ordering argument")
                    edges.setdefault((lock_id, lid), (rel, node.lineno, symbol))
            self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            cb = _is_callback_call(node)
            if cb:
                # waiting on the lock's own condition is how the engine
                # sleeps; calling anything user-facing is the violation
                emit("LCK001", node.lineno,
                     f"user-facing callback {cb}() called while holding {lock_id}",
                     "snapshot state under the lock, invoke the callback after release")
            blk = _is_blocking_call(node)
            if blk:
                emit("LCK002", node.lineno,
                     f"blocking call {blk}() while holding {lock_id}",
                     "release the lock before blocking")
            if terminal_name(node.func) == "acquire":
                recv = node.func.value if isinstance(node.func, ast.Attribute) else None
                lid = mod._lock_id(recv, cls) if recv is not None else None
                if lid is not None and lid != lock_id:
                    emit("LCK003", node.lineno,
                         f"acquires {lid} while holding {lock_id}",
                         "hold one lock at a time")
                    edges.setdefault((lock_id, lid), (rel, node.lineno, symbol))
            # record resolvable calls for transitive reachability
            f = node.func
            if isinstance(f, ast.Attribute) and dotted(f.value) == "self" and cls:
                direct_calls.append((f"{cls}.{f.attr}", node.lineno))
            elif isinstance(f, ast.Name) and f.id in mod.funcs:
                direct_calls.append((f.id, node.lineno))
            self.generic_visit(node)

    r = R()
    for stmt in body:
        r.visit(stmt)

    # transitive: anything a called same-module function does, happens
    # under this lock too
    for key, line in direct_calls:
        seen: set[str] = set()
        stack = [(key, [key], 0)]
        while stack:
            cur, path, depth = stack.pop()
            if cur in seen or depth > _MAX_DEPTH or cur not in mod.funcs:
                continue
            seen.add(cur)
            fs = mod.funcs[cur]
            via = " -> ".join(path)
            for cb, _l in fs.callbacks:
                emit("LCK001", line,
                     f"user-facing callback {cb}() reachable under {lock_id} via {via}",
                     "move the callback outside the locked region")
            for blk, _l in fs.blocking:
                emit("LCK002", line,
                     f"blocking call {blk}() reachable under {lock_id} via {via}",
                     "release the lock before blocking")
            for lid, _l in fs.acquires:
                if lid != lock_id:
                    emit("LCK003", line,
                         f"acquires {lid} under {lock_id} via {via}",
                         "keep the lock ordering global, or restructure")
                    edges.setdefault((lock_id, lid), (rel, line, symbol))
            for nxt, _l in fs.calls:
                stack.append((nxt, path + [nxt], depth + 1))


def _find_cycles(edges: dict[tuple[str, str], tuple[str, int, str]]) -> list[list[str]]:
    graph: dict[str, list[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()

    def dfs(start: str, cur: str, path: list[str], visited: set[str]) -> None:
        for nxt in graph.get(cur, ()):
            if nxt == start:
                cyc = path[:]
                key = tuple(sorted(cyc))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif nxt not in visited:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)

    for node in sorted(graph):
        dfs(node, node, [node], {node})
    return cycles


def check_locks(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}
    for mod in modules:
        if not mod.sim_reachable:
            continue
        ml = _ModuleLocks(mod)
        for lock_id, body, symbol, node in ml.regions:
            cls = symbol.split(".")[0] if "." in symbol else None
            _region_scan(ml, lock_id, body, symbol, cls, findings, edges)
    for cyc in _find_cycles(edges):
        a = cyc[0]
        b = cyc[1 % len(cyc)]
        rel, line, symbol = edges.get((a, b)) or next(iter(edges.values()))
        order = " -> ".join(cyc + [cyc[0]])
        findings.append(Finding(
            rule="LCK004", file=rel, line=line, col=0, symbol=symbol,
            message=f"lock-order cycle: {order} (deadlock risk)",
            hint="pick one global acquisition order and stick to it"))
    return findings
