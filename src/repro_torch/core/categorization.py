"""Failure Categorization Engine (paper §V-A).

Combines the Failure Taxonomy Library with a *root cause analyzer* — a
decision tree over monitoring data from all four layers (§VI-B: "The
failure root cause analyzer in WRATH uses a decision tree to classify
errors") — to produce a :class:`Categorization` the policy engine acts on.

The analyzer:
* classifies the exception via the FTL;
* unwraps dependency failures to their root cause (Table I, strategy RC);
* performs **resource analysis** for runtime-layer failures: compares the
  task's declared requirements against the node's capacity/profile to
  decide whether the failure is a *capacity mismatch* (retry elsewhere,
  possibly with corrected requirements) or *transient contention* (retry in
  place);
* performs **environment analysis** for env-mismatch failures: matches the
  task's package requirements against per-node package availability (the
  ``pip freeze`` probe of §VI-B, simulated by node package sets);
* applies **fail-fast heuristics** (§VI-B): a failure type that has recurred
  across distinct nodes despite placement-sensitive retries is declared
  non-recoverable so the application fails fast.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.failures import (
    DependencyError,
    FailureReport,
    Retriable,
)
from repro_torch.core.taxonomy import DEFAULT_FTL, FailureTaxonomyLibrary, TaxonomyEntry


@dataclass
class Categorization:
    entry: TaxonomyEntry
    resolvable: bool
    resource_related: bool = False
    # WRATH rung-1 corrected requirements (e.g. raise memory_gb to observed)
    suggested_overrides: dict[str, Any] = field(default_factory=dict)
    # node-feasibility requirements derived from root-cause analysis
    required_packages: tuple[str, ...] = ()
    required_memory_gb: float = 0.0
    # whether the failed node itself should be denylisted
    denylist_node: bool = False
    # component to restart ("worker:<node>" etc.), for system failures
    restart_component: str | None = None
    # base backoff before the retry (transient contention), scaled
    # exponentially with the retry count by the policy engine
    retry_delay_s: float = 0.0
    # instance-level override: the root-cause analysis concluded the SAME
    # node can work (e.g. transient contention), even if the failure type
    # is placement-sensitive in general
    in_place_ok: bool | None = None
    explanation: str = ""

    @property
    def placement_sensitive(self) -> bool:
        if self.in_place_ok is not None:
            return not self.in_place_ok
        return self.entry.placement_sensitive


class FailureCategorizationEngine:
    def __init__(self, ftl: FailureTaxonomyLibrary | None = None, monitor=None,
                 *, fail_fast_distinct_nodes: int = 2):
        self.ftl = ftl or DEFAULT_FTL
        self.monitor = monitor
        # placement-sensitive failures recurring on >= this many distinct
        # nodes are declared unresolvable (fail-fast heuristic)
        self.fail_fast_distinct_nodes = fail_fast_distinct_nodes

    # ------------------------------------------------------------------ #
    def categorize(self, record, report: FailureReport) -> Categorization:
        exc = report.exception
        # --- Table I strategy RC: unwrap dependency failures -------------
        if isinstance(exc, DependencyError):
            root = exc.root_cause
            root_entry = self.ftl.classify_exception(root) if root is not None \
                else self.ftl.get("dependency_failure")
            if root is None or root_entry.retriable is Retriable.NO:
                return Categorization(
                    entry=self.ftl.get("dependency_failure"), resolvable=False,
                    explanation=f"dependency root cause "
                                f"{type(root).__name__ if root else 'unknown'} "
                                f"is non-retriable -> fail fast")
            # retriable root cause: the parent would have been retried by
            # WRATH already; a *still-failing* parent means its retries are
            # exhausted -> the child cannot succeed either.
            return Categorization(
                entry=self.ftl.get("dependency_failure"), resolvable=False,
                explanation="dependency failed terminally despite retriable "
                            "root cause -> fail fast")

        entry = self.ftl.classify_exception(
            exc, exc_type_name=report.exception_type, message=report.message)

        # --- layer-specific root-cause analysis --------------------------
        if entry.retriable is Retriable.NO and not entry.placement_sensitive:
            return Categorization(entry=entry, resolvable=False,
                                  explanation=f"{entry.failure_type}: "
                                              f"non-retriable user failure")

        cat = Categorization(entry=entry, resolvable=True)
        if entry.failure_type in ("resource_starvation", "ulimit_exceeded"):
            self._analyze_resources(record, report, cat)
        elif entry.failure_type == "env_mismatch":
            self._analyze_environment(record, report, cat)
        elif entry.failure_type in ("hardware_shutdown", "heartbeat_lost"):
            cat.denylist_node = report.node is not None
            cat.explanation = f"environment failure on {report.node}: denylist node"
        elif entry.failure_type in ("worker_lost",):
            cat.restart_component = f"worker:{report.node}" if report.node else None
            cat.explanation = "worker died: restart workers, retry elsewhere"
        elif entry.failure_type in ("manager_loss", "monitor_loss"):
            cat.restart_component = f"manager:{report.node}" if report.node else "manager:"
            cat.explanation = "framework component lost: restart + retry"
        elif entry.failure_type == "pilot_init_failure":
            cat.denylist_node = report.node is not None
            cat.explanation = "pilot init failed: avoid node, retry elsewhere"
        else:
            cat.explanation = f"{entry.failure_type}: retriable ({entry.default_action})"

        # --- fail-fast heuristics (§VI-B) ---------------------------------
        if self._should_fail_fast(record, report, cat):
            cat.resolvable = False
        return cat

    # ------------------------------------------------------------------ #
    def _analyze_resources(self, record, report: FailureReport,
                           cat: Categorization) -> None:
        cat.resource_related = True
        req = report.requirements or {}
        need = float(req.get("memory_gb", 0.0))
        cap = float(report.resource_profile.get("node_memory_gb", 0.0))
        in_use = float(report.resource_profile.get("node_mem_in_use_gb", 0.0))
        if cat.entry.failure_type == "ulimit_exceeded":
            need_files = int(req.get("open_files", 0))
            cat.suggested_overrides = {}
            cat.explanation = (f"ulimit exceeded (needs ~{need_files} fds): "
                               f"retry on node with higher ulimit")
            cat.required_memory_gb = need
            return
        if cap and need > cap:
            # true capacity mismatch: no retry on this class of node can work
            cat.required_memory_gb = need
            cat.explanation = (f"resource starvation: task needs {need}GB, node "
                               f"capacity {cap}GB -> retry on larger-memory node")
        elif cap and need <= cap and in_use > 0:
            # transient contention: the node could fit the task when idle
            cat.required_memory_gb = need
            cat.retry_delay_s = 0.1
            cat.in_place_ok = True
            cat.explanation = (f"transient contention: {in_use:.1f}GB in use of "
                               f"{cap}GB -> retry with backoff (same node ok)")
        else:
            # no profile: be conservative, request feasibility-aware placement
            cat.required_memory_gb = need
            cat.explanation = "resource starvation (no profile): retry feasibly"

    def _analyze_environment(self, record, report: FailureReport,
                             cat: Categorization) -> None:
        missing = tuple(getattr(report.exception, "missing_packages", ()) or ())
        if not missing and report.message:
            # parse "No module named 'x'" manifestations
            msg = report.message
            if "No module named" in msg:
                mod = msg.split("No module named")[-1].strip().strip("'\" ")
                missing = (mod,) if mod else ()
        req_pkgs = tuple(report.requirements.get("packages", ()) or ())
        cat.required_packages = tuple(sorted(set(missing) | set(req_pkgs)))
        cat.explanation = (f"environment mismatch: node lacks "
                           f"{list(missing) or list(req_pkgs)} -> retry on node "
                           f"with matching environment (pip-freeze match)")

    # ------------------------------------------------------------------ #
    def _should_fail_fast(self, record, report: FailureReport,
                          cat: Categorization) -> bool:
        """Heuristic from §VI-B: error type + retry count + node diversity."""
        attempts = getattr(record, "attempts", [])
        same_err_nodes = {a["node"] for a in attempts
                          if a.get("error") == report.exception_type}
        if report.node:
            same_err_nodes.add(report.node)
        if not cat.placement_sensitive:
            # in-place-retriable failure that keeps happening: give it the
            # full retry budget, no early fail-fast (random seed errors may
            # legitimately take several tries)
            return False
        # placement-sensitive: if it failed identically on enough distinct
        # nodes *of distinct pools* we conclude no placement can fix it
        pools_tried = {a["pool"] for a in attempts
                       if a.get("error") == report.exception_type}
        if report.pool:
            pools_tried.add(report.pool)
        if (len(same_err_nodes) >= self.fail_fast_distinct_nodes
                and len(pools_tried) >= 2):
            cat.explanation += (f" | fail-fast: {report.exception_type} recurred on "
                                f"{len(same_err_nodes)} nodes across "
                                f"{len(pools_tried)} pools")
            return True
        return False
