"""TBPP substrate, the part the serving plane reaches: tasks, cluster,
event loop, scheduler and resilience policies.

These modules are copies of ``src/repro/engine/`` with only their
imports rewritten; the DataFlowKernel, executor and workflow scopes are
not ported yet (ROADMAP.md, 'Next slices' item 5).
"""
