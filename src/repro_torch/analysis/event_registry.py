"""Checked-in registry of every monitor-event and gauge name.

GENERATED by ``python -m repro_torch.analysis --update-registry`` from the
name literals in ``src/repro_torch`` — edit code, not this file.  The chaos
search's coverage tokens and the golden sim traces key off these exact
strings; an unregistered name fails the build (EVT001), and CI checks
this file matches the code (``--check-registry``).
"""
from __future__ import annotations

TASK_EVENTS = frozenset({
    'cancelled',
    'error',
    'finished',
    'memo_rollback',
    'memoized',
    'preempted',
    'replicated',
    'retry_decision',
    'scheduled',
    'speculative_copy',
    'stolen',
    'submitted',
})

SYSTEM_EVENTS = frozenset({
    'autoscale_grow',
    'autoscale_shrink',
    'denylist_add',
    'denylist_remove',
    'engine_restart',
    'event_error',
    'fault_injected',
    'heartbeat_lost',
    'heartbeat_resumed',
    'host_join',
    'host_leave',
    'node_drain',
    'node_join',
    'node_leave',
    'node_undrain',
    'policy_error',
    'replica_lost',
    'request_admitted',
    'request_done',
    'request_rejected',
    'request_shed',
    'serve_event_error',
    'workflow_cancelled',
})

GAUGES = frozenset({
    'serve.queue_depth',
    'serve.slot_occupancy',
})

#: dynamic-name families (``f"fault_{kind}"`` …); members are closed
#: sets owned by the emitting module
PREFIXES = ('fault_', 'proactive_')
