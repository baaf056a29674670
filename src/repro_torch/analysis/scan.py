"""Shared AST plumbing: module discovery, scope tracking, name resolution.

Checkers operate on :class:`Module` objects — a parsed AST plus a
package-relative path used both for reporting and for scope filters
(clock/lock discipline only applies to sim-reachable packages; loose
files passed explicitly — e.g. test fixtures — are always in scope).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

#: packages whose code is reachable from the deterministic sim plane —
#: the scope of the clock- and lock-discipline checkers
SIM_REACHABLE = ("engine", "core", "serve", "sim", "train")


@dataclass
class Module:
    path: Path      # absolute filesystem path
    rel: str        # package-relative posix path (or bare filename)
    tree: ast.Module
    sim_reachable: bool  # subject to clock/lock discipline?


def _load(path: Path, rel: str, sim_reachable: bool) -> Module:
    tree = ast.parse(path.read_text(), filename=str(path))
    return Module(path=path, rel=rel, tree=tree, sim_reachable=sim_reachable)


def find_modules(roots: list[Path]) -> list[Module]:
    """Collect modules under each root (package dir or single file).

    For a package root (e.g. ``src/repro_torch``) every ``*.py`` beneath it is
    scanned; ``rel`` is the root-relative path and sim-reachability is
    decided by the top-level package name.  A single-file root is always
    fully in scope (fixture files exercise every checker).
    """
    modules: list[Module] = []
    for root in roots:
        root = root.resolve()
        if root.is_file():
            modules.append(_load(root, root.name, sim_reachable=True))
            continue
        for path in sorted(root.rglob("*.py")):
            rel = path.relative_to(root).as_posix()
            top = rel.split("/", 1)[0]
            # files directly under the root (no package prefix to judge
            # by) are fully in scope, like single-file roots
            in_scope = top in SIM_REACHABLE or "/" not in rel
            modules.append(_load(path, rel, sim_reachable=in_scope))
    return modules


def dotted(node: ast.AST) -> str | None:
    """Render an attribute chain of Names as ``a.b.c`` (else None)."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


def terminal_name(node: ast.AST) -> str | None:
    """The last component of a call target: ``a.b.c()`` -> ``c``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing class/function qualname."""

    def __init__(self) -> None:
        self._scope: list[str] = []
        self._class_stack: list[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    @property
    def current_class(self) -> str | None:
        return self._class_stack[-1] if self._class_stack else None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()
        self._scope.pop()

    def _visit_func(self, node: ast.AST) -> None:
        self._scope.append(node.name)  # type: ignore[attr-defined]
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def import_aliases(tree: ast.Module) -> tuple[dict[str, str], dict[str, str]]:
    """Map local names to canonical modules / dotted origins.

    Returns ``(mod_alias, from_alias)``: ``import time as _t`` yields
    ``mod_alias["_t"] == "time"``; ``from time import sleep as zzz``
    yields ``from_alias["zzz"] == "time.sleep"``.
    """
    mod_alias: dict[str, str] = {}
    from_alias: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod_alias[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                from_alias[a.asname or a.name] = f"{node.module}.{a.name}"
    return mod_alias, from_alias


def canonical(node: ast.AST, mod_alias: dict[str, str],
              from_alias: dict[str, str]) -> str | None:
    """Canonical dotted origin of a Name/Attribute, through import aliases.

    ``_time.sleep`` -> ``time.sleep``; with ``from datetime import
    datetime``, ``datetime.now`` -> ``datetime.datetime.now``.
    """
    name = dotted(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in from_alias:
        base = from_alias[head]
    elif head in mod_alias:
        base = mod_alias[head]
    else:
        return None
    return f"{base}.{rest}" if rest else base
