"""Failure hierarchy for WRATH (paper §III, Table I).

Every failure that can surface in a TBPP system is represented as an
exception type tagged with the TBPP layer it originates from.  The
Failure Taxonomy Library (``taxonomy.py``) maps these — plus ordinary
Python exceptions raised by user task code — to categories, retriability
verdicts and policy actions.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any


class Layer(enum.Enum):
    """The four layers of a TBPP framework (paper Fig. 1)."""

    APPLICATION = "application"
    FRAMEWORK = "framework"
    RUNTIME = "runtime"
    ENVIRONMENT = "environment"


class DetectionStrategy(enum.Enum):
    """How a failure type is detected (paper Table I)."""

    FTL = "failure_taxonomy_library"
    RP = "resource_profiling"
    FTL_RP = "ftl_plus_resource_profiling"
    RC = "root_cause"


class Retriable(enum.Enum):
    YES = "yes"
    NO = "no"
    ROOT_CAUSE = "depends_on_root_cause"


# ---------------------------------------------------------------------------
# Framework-level exception types (raised by the runtime itself, not user code)
# ---------------------------------------------------------------------------


class WrathFailure(Exception):
    """Base class for failures raised by the TBPP substrate itself."""

    layer: Layer = Layer.FRAMEWORK

    def __init__(self, message: str = "", **context: Any):
        super().__init__(message)
        self.context = context


# -- Framework layer (System Failures) --------------------------------------


class MonitorLossError(WrathFailure):
    """The component overseeing task execution became unavailable."""

    layer = Layer.FRAMEWORK


class ManagerLossError(WrathFailure):
    """The central/node manager responsible for tasks failed."""

    layer = Layer.FRAMEWORK


class WorkerLostError(WrathFailure):
    """A worker process died while executing a task (killed / crashed)."""

    layer = Layer.FRAMEWORK


class TaskCancelledError(WrathFailure):
    """The framework cancelled the task before/while it ran.

    Raised into the task's future by the proactive plane's predictive
    fast-fail and by explicit :meth:`DataFlowKernel.cancel_task` — a
    *decision*, not a manifestation, so it never re-enters the retry
    handler.
    """

    layer = Layer.FRAMEWORK


class DependencyError(WrathFailure):
    """A task failed because one of its parent tasks failed.

    Retriability depends on the *root cause* of the parent failure
    (paper Table I, detection strategy RC).
    """

    layer = Layer.FRAMEWORK

    def __init__(self, message: str = "", root_cause: BaseException | None = None, **ctx: Any):
        super().__init__(message, **ctx)
        self.root_cause = root_cause


# -- Runtime layer (Resource Failures) ---------------------------------------


class ResourceStarvationError(WrathFailure):
    """Task did not receive sufficient CPU/memory/storage."""

    layer = Layer.RUNTIME


class UlimitExceededError(ResourceStarvationError):
    """Too many open files / process limits exceeded (Table III 'ulimit')."""

    layer = Layer.RUNTIME


class PilotJobInitError(WrathFailure):
    """The pilot job failed to start or initialize correctly."""

    layer = Layer.RUNTIME


# -- Environment layer (Hardware & Environment Failures) --------------------


class HardwareShutdownError(WrathFailure):
    """A server / storage device / network component powered down."""

    layer = Layer.ENVIRONMENT


class EnvironmentMismatchError(WrathFailure):
    """The software environment on the node does not match requirements.

    The Python-native manifestation is ``ImportError`` /
    ``ModuleNotFoundError``; the simulator raises this subclass so that
    both spellings flow through the same taxonomy entry.
    """

    layer = Layer.ENVIRONMENT

    def __init__(self, message: str = "", missing_packages: tuple[str, ...] = (), **ctx: Any):
        super().__init__(message, **ctx)
        self.missing_packages = missing_packages


class HeartbeatLostError(WrathFailure):
    """A component stopped heartbeating (detected, not raised in-line)."""

    layer = Layer.ENVIRONMENT


# -- Application layer helpers ----------------------------------------------


class RandomSeedError(WrathFailure):
    """Sporadic, seed-dependent user failure (e.g. MolDesign init, §III-A).

    Retriable: re-generation with a fresh seed may succeed.
    """

    layer = Layer.APPLICATION


class NumericalDivergenceError(WrathFailure):
    """Training-plane application failure: loss became NaN/Inf.

    This class has no Parsl analog; it is our training-specific extension
    (DESIGN.md §2).  Retriable with a different data order / restored
    checkpoint, akin to a Random Seed Error.
    """

    layer = Layer.APPLICATION


# ---------------------------------------------------------------------------
# Failure record — what the monitoring system ships to the categorizer
# ---------------------------------------------------------------------------


@dataclass
class FailureReport:
    """Everything known about one observed failure manifestation (§III-B)."""

    task_id: str | None
    exception: BaseException | None
    exception_type: str
    message: str
    node: str | None = None
    pool: str | None = None
    worker: str | None = None
    # resource profile at (or near) failure time, from the task monitor agent
    resource_profile: dict[str, float] = field(default_factory=dict)
    # declared task requirements, for resource-mismatch analysis
    requirements: dict[str, Any] = field(default_factory=dict)
    retry_count: int = 0
    timestamp: float = 0.0
    # log lines captured around failure (stdout/err of the worker)
    log_tail: list[str] = field(default_factory=list)

    @classmethod
    def from_exception(cls, exc: BaseException, **kw: Any) -> "FailureReport":
        return cls(
            task_id=kw.pop("task_id", None),
            exception=exc,
            exception_type=type(exc).__name__,
            message=str(exc),
            **kw,
        )
