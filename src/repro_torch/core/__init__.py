"""WRATH core: failure taxonomy, monitoring, categorization, policy, retry.

The paper's contribution (§III–§V) as a composable module: plug
:func:`wrath_retry_handler` into a :class:`~repro.engine.dfk.DataFlowKernel`
(task plane) or into the training supervisor (training plane).

Re-exports are lazy (PEP 562) because ``repro.engine`` depends on
``repro.core.failures`` while ``repro.core.retry``/``policy`` depend on
``repro.engine`` — laziness breaks the package-init cycle.
"""
from __future__ import annotations

_EXPORTS = {
    # failures
    "Layer": "repro_torch.core.failures",
    "Retriable": "repro_torch.core.failures",
    "DetectionStrategy": "repro_torch.core.failures",
    "FailureReport": "repro_torch.core.failures",
    "WrathFailure": "repro_torch.core.failures",
    "MonitorLossError": "repro_torch.core.failures",
    "ManagerLossError": "repro_torch.core.failures",
    "WorkerLostError": "repro_torch.core.failures",
    "TaskCancelledError": "repro_torch.core.failures",
    "DependencyError": "repro_torch.core.failures",
    "ResourceStarvationError": "repro_torch.core.failures",
    "UlimitExceededError": "repro_torch.core.failures",
    "PilotJobInitError": "repro_torch.core.failures",
    "HardwareShutdownError": "repro_torch.core.failures",
    "EnvironmentMismatchError": "repro_torch.core.failures",
    "HeartbeatLostError": "repro_torch.core.failures",
    "RandomSeedError": "repro_torch.core.failures",
    "NumericalDivergenceError": "repro_torch.core.failures",
    # taxonomy
    "DEFAULT_FTL": "repro_torch.core.taxonomy",
    "FailureTaxonomyLibrary": "repro_torch.core.taxonomy",
    "TaxonomyEntry": "repro_torch.core.taxonomy",
    "TABLE_I": "repro_torch.core.taxonomy",
    # monitoring
    "MonitoringDatabase": "repro_torch.core.monitoring",
    "StreamingStats": "repro_torch.core.monitoring",
    "NodeHealth": "repro_torch.core.monitoring",
    "TemplateProfile": "repro_torch.core.monitoring",
    "Radio": "repro_torch.core.monitoring",
    "InProcRadio": "repro_torch.core.monitoring",
    "TCPRadio": "repro_torch.core.monitoring",
    "TCPRadioServer": "repro_torch.core.monitoring",
    "SystemMonitoringAgent": "repro_torch.core.monitoring",
    "TaskMonitoringAgent": "repro_torch.core.monitoring",
    # categorization / retry / policy
    "Categorization": "repro_torch.core.categorization",
    "FailureCategorizationEngine": "repro_torch.core.categorization",
    "HierarchicalRetryPlanner": "repro_torch.core.retry",
    "Placement": "repro_torch.core.retry",
    "ResiliencePolicyEngine": "repro_torch.core.policy",
    "wrath_retry_handler": "repro_torch.core.policy",
    # proactive resilience plane
    "ProactiveConfig": "repro_torch.core.proactive",
    "ProactiveDecision": "repro_torch.core.proactive",
    "ProactiveSentinel": "repro_torch.core.proactive",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    import importlib

    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return __all__
