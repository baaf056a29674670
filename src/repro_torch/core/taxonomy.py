"""Failure Taxonomy Library (FTL) — paper §V-A, Table I.

The FTL maps observed failure manifestations (exception types, heartbeat
loss, resource-log anomalies) to taxonomy entries: which TBPP layer the
failure belongs to, whether it is retriable, the detection strategy that
identifies it, and the default policy action.

The library ships with the full Table I taxonomy plus the summarized Python
exception map for application-layer failures (§V-A: "for failures that occur
at the application layer, we summarize the exceptions and errors that may
occur in Python"), and is user-extensible (§VI-B: "users can define custom
rules for failure categorization").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Type

from repro_torch.core.failures import (
    DependencyError,
    DetectionStrategy,
    EnvironmentMismatchError,
    HardwareShutdownError,
    HeartbeatLostError,
    Layer,
    ManagerLossError,
    MonitorLossError,
    NumericalDivergenceError,
    PilotJobInitError,
    RandomSeedError,
    ResourceStarvationError,
    Retriable,
    UlimitExceededError,
    WorkerLostError,
)


@dataclass(frozen=True)
class TaxonomyEntry:
    """One row of the failure taxonomy (paper Table I)."""

    failure_type: str
    layer: Layer
    retriable: Retriable
    detection: DetectionStrategy
    # default policy action name (resolved by the policy engine)
    default_action: str
    # whether the failure is tied to properties of the node it ran on —
    # if True, retrying *elsewhere* may succeed even though retrying
    # in-place will not (drives the hierarchical retry ladder)
    placement_sensitive: bool = False
    description: str = ""


# --------------------------------------------------------------------------
# Table I, rendered as data
# --------------------------------------------------------------------------

TABLE_I: dict[str, TaxonomyEntry] = {
    e.failure_type: e for e in [
        # -- Application layer (User Failures) ---------------------------
        TaxonomyEntry("syntax_error", Layer.APPLICATION, Retriable.NO,
                      DetectionStrategy.FTL, "terminate",
                      description="Mistakes that violate language syntax."),
        TaxonomyEntry("logic_error", Layer.APPLICATION, Retriable.NO,
                      DetectionStrategy.FTL, "terminate",
                      description="Out-of-bounds indexing, bad types, etc."),
        TaxonomyEntry("random_seed_error", Layer.APPLICATION, Retriable.YES,
                      DetectionStrategy.FTL, "retry_in_place",
                      description="Sporadic seed-dependent failure (MolDesign)."),
        TaxonomyEntry("numerical_divergence", Layer.APPLICATION, Retriable.YES,
                      DetectionStrategy.FTL, "retry_in_place",
                      description="Training-plane NaN/Inf loss (our extension)."),
        # -- Framework layer (System Failures) ---------------------------
        TaxonomyEntry("monitor_loss", Layer.FRAMEWORK, Retriable.YES,
                      DetectionStrategy.FTL, "restart_component",
                      description="Task-overseeing component unavailable."),
        TaxonomyEntry("manager_loss", Layer.FRAMEWORK, Retriable.YES,
                      DetectionStrategy.FTL, "restart_component",
                      description="Central/node manager failed."),
        TaxonomyEntry("worker_lost", Layer.FRAMEWORK, Retriable.YES,
                      DetectionStrategy.FTL, "restart_component",
                      placement_sensitive=True,
                      description="Worker process died mid-task."),
        TaxonomyEntry("dependency_failure", Layer.FRAMEWORK, Retriable.ROOT_CAUSE,
                      DetectionStrategy.RC, "root_cause",
                      description="Parent failure cascaded to child."),
        # -- Runtime layer (Resource Failures) ----------------------------
        TaxonomyEntry("resource_starvation", Layer.RUNTIME, Retriable.YES,
                      DetectionStrategy.RP, "hierarchical_retry",
                      placement_sensitive=True,
                      description="Insufficient CPU/memory/storage."),
        TaxonomyEntry("ulimit_exceeded", Layer.RUNTIME, Retriable.YES,
                      DetectionStrategy.RP, "hierarchical_retry",
                      placement_sensitive=True,
                      description="Open-file / process limits exceeded."),
        TaxonomyEntry("pilot_init_failure", Layer.RUNTIME, Retriable.YES,
                      DetectionStrategy.RP, "hierarchical_retry",
                      placement_sensitive=True,
                      description="Pilot job failed to initialize."),
        # -- Environment layer (Hardware & Environment) --------------------
        TaxonomyEntry("hardware_shutdown", Layer.ENVIRONMENT, Retriable.YES,
                      DetectionStrategy.FTL_RP, "denylist_and_retry",
                      placement_sensitive=True,
                      description="Server/storage/network component failed."),
        TaxonomyEntry("heartbeat_lost", Layer.ENVIRONMENT, Retriable.YES,
                      DetectionStrategy.FTL_RP, "denylist_and_retry",
                      placement_sensitive=True,
                      description="Component stopped heartbeating."),
        TaxonomyEntry("env_mismatch", Layer.ENVIRONMENT, Retriable.NO,
                      DetectionStrategy.FTL, "hierarchical_retry",
                      placement_sensitive=True,
                      description="Missing software/libraries on the node. "
                                  "Non-retriable in place; retriable on a node "
                                  "whose environment matches (paper §VI-B)."),
    ]
}


# --------------------------------------------------------------------------
# Python exception map → taxonomy entries (application-layer FTL, §V-A/§VI-B)
# --------------------------------------------------------------------------

# user-code exceptions that will deterministically recur -> terminate
_LOGIC_ERRORS: tuple[Type[BaseException], ...] = (
    ZeroDivisionError, IndexError, KeyError, TypeError, ValueError,
    AttributeError, AssertionError, NotImplementedError, ArithmeticError,
    OverflowError, RecursionError, UnboundLocalError, NameError,
)
_SYNTAX_ERRORS: tuple[Type[BaseException], ...] = (SyntaxError, IndentationError)

EXCEPTION_MAP: list[tuple[Type[BaseException], str]] = [
    # wrath substrate exceptions first (most specific)
    (UlimitExceededError, "ulimit_exceeded"),
    (ResourceStarvationError, "resource_starvation"),
    (PilotJobInitError, "pilot_init_failure"),
    (EnvironmentMismatchError, "env_mismatch"),
    (HardwareShutdownError, "hardware_shutdown"),
    (HeartbeatLostError, "heartbeat_lost"),
    (WorkerLostError, "worker_lost"),
    (ManagerLossError, "manager_loss"),
    (MonitorLossError, "monitor_loss"),
    (DependencyError, "dependency_failure"),
    (RandomSeedError, "random_seed_error"),
    (NumericalDivergenceError, "numerical_divergence"),
    # plain-Python manifestations
    (MemoryError, "resource_starvation"),
    (ModuleNotFoundError, "env_mismatch"),
    (ImportError, "env_mismatch"),
    (SyntaxError, "syntax_error"),           # also covers IndentationError
    (OSError, "ulimit_exceeded"),            # EMFILE et al. — refined by RP
    (ConnectionError, "manager_loss"),
    (TimeoutError, "heartbeat_lost"),
]
EXCEPTION_MAP += [(t, "logic_error") for t in _LOGIC_ERRORS]


class FailureTaxonomyLibrary:
    """Queryable FTL with user-extensible rules (paper §V-A, §VI-B)."""

    def __init__(self) -> None:
        self.entries: dict[str, TaxonomyEntry] = dict(TABLE_I)
        self._exc_map: list[tuple[Type[BaseException], str]] = list(EXCEPTION_MAP)
        self._message_rules: list[tuple[str, str]] = [
            # substring-of-message rules, applied when the type is ambiguous
            ("too many open files", "ulimit_exceeded"),
            ("out of memory", "resource_starvation"),
            ("cannot allocate", "resource_starvation"),
            ("no module named", "env_mismatch"),
            ("heartbeat", "heartbeat_lost"),
            ("nan", "numerical_divergence"),
        ]

    # -- extension API ----------------------------------------------------
    def register_entry(self, entry: TaxonomyEntry) -> None:
        self.entries[entry.failure_type] = entry

    def register_exception(self, exc_type: Type[BaseException], failure_type: str) -> None:
        if failure_type not in self.entries:
            raise KeyError(f"unknown failure type {failure_type!r}")
        self._exc_map.insert(0, (exc_type, failure_type))

    def register_message_rule(self, substring: str, failure_type: str) -> None:
        self._message_rules.insert(0, (substring.lower(), failure_type))

    # -- lookup -------------------------------------------------------------
    def classify_exception(self, exc: BaseException | None,
                           exc_type_name: str = "", message: str = "") -> TaxonomyEntry:
        """Classify by exception type, falling back to message rules, then
        to the conservative default (logic_error → terminate, the paper's
        'non-Python-package failures are application-layer, non-recoverable,
        require user intervention' rule, §VI-B)."""
        if exc is not None:
            for exc_type, ftype in self._exc_map:
                if isinstance(exc, exc_type):
                    return self.entries[ftype]
            message = message or str(exc)
        msg = (message or "").lower()
        for sub, ftype in self._message_rules:
            if sub in msg:
                return self.entries[ftype]
        if exc_type_name:
            for exc_type, ftype in self._exc_map:
                if exc_type.__name__ == exc_type_name:
                    return self.entries[ftype]
        return self.entries["logic_error"]

    def get(self, failure_type: str) -> TaxonomyEntry:
        return self.entries[failure_type]


DEFAULT_FTL = FailureTaxonomyLibrary()
