"""HOK: hook exception-safety — raises must meet a degrade path.

:class:`~repro_torch.engine.policies.PolicyStack` wraps every hook fan-out in
``try/except`` with *documented* per-hook degrade semantics (a raising
``on_failure`` fails the task terminally; a raising reviewer lets the
decision stand; a raising admitter admits).  A hook invoked directly —
not through the stack, not under a local ``try`` — turns any policy bug
into an engine crash on whatever thread happened to fire it.

=======  ==========================================================
HOK001   direct hook invocation with no degrade path: the receiver
         is not a policy stack and the call sits outside any
         exception-catching ``try``
HOK002   explicit ``raise`` inside a ``ResiliencePolicy`` hook
         override — it relies on the stack's per-hook degrade
         semantics; confirm them and baseline with the reason
=======  ==========================================================

Receivers named ``policies``/``stack``/``policy`` are assumed to be
:class:`PolicyStack` instances (the engine's convention), and
``engine/policies.py`` itself is exempt — its per-policy calls *are*
the degrade path.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.scan import Module, ScopedVisitor, dotted

#: the ResiliencePolicy hook surface (keep in sync with engine/policies.py)
HOOK_NAMES = frozenset({
    "on_submit", "on_dispatch", "on_running", "on_failure", "on_result",
    "on_tick", "review_decision", "admit_request", "memo_lookup",
    "memo_commit", "memo_invalidate", "bind", "unbind",
})

#: HOK001 scope: runtime fan-out hooks only.  Lifecycle ``bind``/
#: ``unbind`` are excluded — a failing bind *should* propagate at
#: session start (and ``bind`` is too generic a name: schedulers and
#: sockets bind too) — as is ``on_result``-style dispatch through an
#: object's *own* callback attribute (``self.on_result`` is the engine's
#: completion pipeline, not a policy invocation).
RUNTIME_HOOKS = HOOK_NAMES - {"bind", "unbind"}

#: receiver names assumed to be PolicyStack instances (engine convention)
SAFE_RECEIVERS = frozenset({"policies", "stack", "policy", "_policies"})

#: the stack module: its per-policy fan-out calls ARE the degrade path
EXEMPT_MODULES = frozenset({"engine/policies.py"})


def _receiver_tail(expr: ast.AST) -> str | None:
    name = dotted(expr)
    if name is None:
        return None
    return name.split(".")[-1]


def _catches_broadly(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted(e) or "" for e in t.elts]
    else:
        names = [dotted(t) or ""]
    return any(n.split(".")[-1] in ("Exception", "BaseException") for n in names)


class _HookCallVisitor(ScopedVisitor):
    def __init__(self, mod: Module):
        super().__init__()
        self.mod = mod
        self.findings: list[Finding] = []
        self._try_depth = 0  # inside a broadly-catching try body?

    def visit_Try(self, node: ast.Try) -> None:
        protected = any(_catches_broadly(h) for h in node.handlers)
        if protected:
            self._try_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if protected:
            self._try_depth -= 1
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in RUNTIME_HOOKS
                and self._try_depth == 0):
            tail = _receiver_tail(f.value)
            is_super = (isinstance(f.value, ast.Call)
                        and isinstance(f.value.func, ast.Name)
                        and f.value.func.id == "super")
            is_own_attr = isinstance(f.value, ast.Name) and f.value.id == "self"
            if tail not in SAFE_RECEIVERS and not is_super and not is_own_attr:
                self.findings.append(Finding(
                    rule="HOK001", file=self.mod.rel, line=node.lineno,
                    col=node.col_offset, symbol=self.symbol,
                    message=f"hook {f.attr}() invoked on {dotted(f.value) or '<expr>'} "
                            "with no degrade path",
                    hint="route it through the PolicyStack, or wrap the call "
                         "in try/except with explicit degrade semantics"))
        self.generic_visit(node)


def _policy_subclasses(tree: ast.Module) -> list[ast.ClassDef]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for base in node.bases:
                name = dotted(base) or ""
                if name.split(".")[-1] == "ResiliencePolicy":
                    out.append(node)
                    break
    return out


def _raises_in(fn: ast.FunctionDef) -> list[ast.Raise]:
    """Raise statements lexically in ``fn`` (nested defs excluded)."""
    out: list[ast.Raise] = []

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Raise):
                out.append(child)
            rec(child)

    rec(fn)
    return out


def check_hooks(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if mod.rel in EXEMPT_MODULES:
            continue
        v = _HookCallVisitor(mod)
        v.visit(mod.tree)
        findings += v.findings
        # HOK002: raising hook overrides
        for cls in _policy_subclasses(mod.tree):
            for item in cls.body:
                if not isinstance(item, ast.FunctionDef) or item.name not in HOOK_NAMES:
                    continue
                for sub in _raises_in(item):
                    findings.append(Finding(
                        rule="HOK002", file=mod.rel, line=sub.lineno,
                        col=sub.col_offset,
                        symbol=f"{cls.name}.{item.name}",
                        message=f"hook {item.name}() raises; it relies on the "
                                "PolicyStack's per-hook degrade semantics",
                        hint="prefer returning a decision; if raising is the "
                             "intended degrade, baseline with the semantics"))
    return findings
