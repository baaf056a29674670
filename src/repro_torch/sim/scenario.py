"""Scenario DSL: scripted and seeded-random failure schedules.

A :class:`Scenario` is a fully-declarative description of one simulated
run — the cluster shape, the task arrivals (with per-task virtual
durations, DAG edges and injected Table III failure behaviours, reusing
:mod:`repro_torch.injection.engines`'s function-replacement / spec-modification
split) and a timed :class:`Fault` schedule (node loss, heartbeat silence,
worker kills, drains, workflow cancellation).

Scenarios come from two places:

* hand-written — ``Scenario(seed=0, nodes=[...], tasks=[...],
  faults=[...])`` for regression tests that pin one interleaving;
* sampled — :meth:`Scenario.random` draws every choice from one
  ``random.Random(seed)``, so **the seed is the scenario**: printing a
  failing campaign's seed is a complete reproduction recipe.
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Any

from repro_torch.injection.engines import FN_REPLACEMENT, SPEC_MODIFICATION

__all__ = ["Fault", "NodeSpec", "SimTaskSpec", "Scenario", "FAULT_KINDS",
           "TASK_FAILURE_KINDS", "CORRELATED_FAULT_KINDS"]

#: scripted fault-event kinds the harness knows how to apply
FAULT_KINDS = ("node_down", "node_up", "hb_pause", "hb_resume",
               "worker_kill", "drain", "undrain", "cancel_workflow",
               "engine_crash",
               # correlated / elastic kinds (coverage-guided chaos search)
               "zone_down", "zone_up", "partition", "partition_heal",
               "mass_preempt", "node_join", "node_leave")

#: the correlated-outage subset: one fault touches many components at once
CORRELATED_FAULT_KINDS = ("zone_down", "zone_up", "partition",
                          "partition_heal", "mass_preempt",
                          "node_join", "node_leave")

#: kinds that must name a single target node
_NODE_SCOPED = ("node_down", "node_up", "hb_pause", "hb_resume",
                "worker_kill", "drain", "undrain", "partition",
                "partition_heal", "node_leave")

#: injectable per-task failure behaviours (Table III, both flavours)
TASK_FAILURE_KINDS = tuple(FN_REPLACEMENT) + tuple(SPEC_MODIFICATION)


@dataclass(frozen=True)
class Fault:
    """One timed environment/runtime fault.

    ``engine_crash`` is engine-scoped (no node/workflow target): the
    harness tears the whole :class:`~repro_torch.engine.dfk.DataFlowKernel`
    down mid-run and rebuilds it against the same lineage-aware
    :class:`~repro_torch.checkpoint.task_store.TaskStore`, replaying the
    workflow script — the checkpoint/restart plane's chaos scenario.

    Correlated kinds model real outages that hit many components in one
    tick:

    * ``zone_down`` / ``zone_up`` — a whole node group (rack/zone) lost
      or restored at once (``nodes=`` names the group);
    * ``partition`` / ``partition_heal`` — a network partition that cuts
      the *task/data* path to ``node`` while its **heartbeats keep
      flowing**: queued work stalls, in-flight completions are held until
      the heal, and the engine sees a healthy-looking node that delivers
      nothing (the straggler plane's blind spot);
    * ``mass_preempt`` — spot-instance reclaim: a seeded ``fraction`` of
      all alive workers killed in one tick, busy ones first;
    * ``node_join`` / ``node_leave`` — elastic membership: a new node
      (``spec=``) joins the running cluster mid-scenario, or an existing
      ``node`` is decommissioned (its queued/running work reroutes
      through the normal failure path).
    """

    at: float                      # virtual seconds from scenario start
    kind: str                      # one of FAULT_KINDS
    node: str | None = None        # target node (node-scoped kinds)
    workflow: str | None = None    # target scope (cancel_workflow)
    nodes: tuple[str, ...] = ()    # target group (zone_down / zone_up)
    fraction: float = 0.0          # killed worker fraction (mass_preempt)
    spec: "NodeSpec | None" = None  # joining node's shape (node_join)

    def __post_init__(self) -> None:
        # Validate the target fields per kind at construction: a
        # mis-targeted fault used to crash deep inside the harness
        # mid-campaign with an opaque KeyError/AttributeError; failing
        # here names the field that is wrong.
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.kind in _NODE_SCOPED and not self.node:
            raise ValueError(
                f"fault kind {self.kind!r} is node-scoped and requires "
                f"node=<name> (got node={self.node!r})")
        if self.kind == "cancel_workflow" and not self.workflow:
            raise ValueError(
                "fault kind 'cancel_workflow' requires workflow=<scope "
                f"name> (got workflow={self.workflow!r})")
        if self.kind in ("zone_down", "zone_up") and not self.nodes:
            raise ValueError(
                f"fault kind {self.kind!r} targets a node group and "
                f"requires nodes=(<name>, ...) (got nodes={self.nodes!r})")
        if self.kind == "mass_preempt" and not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"fault kind 'mass_preempt' requires 0 < fraction <= 1 "
                f"(got fraction={self.fraction!r})")
        if self.kind == "node_join":
            if self.spec is None:
                raise ValueError(
                    "fault kind 'node_join' requires spec=NodeSpec(...) "
                    "describing the joining node")
            if self.node is not None and self.node != self.spec.name:
                raise ValueError(
                    f"node_join node={self.node!r} contradicts "
                    f"spec.name={self.spec.name!r}")


@dataclass(frozen=True)
class NodeSpec:
    """Shape of one simulated node (single ``sim`` pool)."""

    name: str
    memory_gb: float = 192.0
    speed: float = 1.0
    workers: int = 2
    packages: tuple[str, ...] = ("numpy", "jax")
    ulimit_files: int = 1024


@dataclass(frozen=True)
class SimTaskSpec:
    """One task arrival.

    ``fail`` is ``None`` (healthy) or a Table III behaviour:
    function-replacement kinds (``zero_division``/``exception``/
    ``worker_killed``/``dependency``) always fail wherever they run —
    the "destined to fail" tasks; spec-modification kinds (``memory``/
    ``import``/``ulimit``) rewrite the resource spec so the task fails on
    inadequate nodes but succeeds on adequate ones — the *resolvable*
    failures WRATH fixes by re-placement.
    """

    at: float
    name: str
    duration: float = 0.05
    fail: str | None = None
    memory_gb: float = 0.5
    depends_on: tuple[int, ...] = ()   # indices of earlier SimTaskSpecs
    max_retries: int | None = None
    workflow: str | None = None        # scope name (None = engine root)


@dataclass
class Scenario:
    """A complete seeded simulation script."""

    seed: int
    nodes: list[NodeSpec] = field(default_factory=list)
    tasks: list[SimTaskSpec] = field(default_factory=list)
    faults: list[Fault] = field(default_factory=list)
    #: virtual-time budget; the campaign flags any future unresolved by then
    horizon: float = 120.0
    #: propagation mode per workflow scope name used by tasks/faults
    workflows: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.nodes:
            self.nodes = [NodeSpec(name=f"sim-n{i:02d}") for i in range(3)]
        for i, t in enumerate(self.tasks):
            for d in t.depends_on:
                if not 0 <= d < i:
                    raise ValueError(
                        f"task {i} depends on {d}: edges must point at "
                        f"earlier tasks")

    # ------------------------------------------------------------------ #
    @property
    def durations(self) -> dict[str, float]:
        """Template-name → nominal virtual duration (SimExecutor script)."""
        return {t.name: t.duration for t in self.tasks}

    def describe(self) -> str:
        injected = sum(1 for t in self.tasks if t.fail)
        return (f"Scenario(seed={self.seed}): {len(self.nodes)} nodes, "
                f"{len(self.tasks)} tasks ({injected} injected), "
                f"{len(self.faults)} faults, horizon={self.horizon}s")

    # ------------------------------------------------------------------ #
    # Serialization: scenarios travel as JSON (repro corpus under tests/,
    # nightly CI artifacts, shrinker byte-identical re-checks).
    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        for f in d["faults"]:
            f["nodes"] = list(f["nodes"])
        return d

    def to_json(self, *, indent: int | None = None) -> str:
        """Canonical JSON: sorted keys, no float noise beyond repr."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Scenario":
        nodes = [NodeSpec(**{**n, "packages": tuple(n.get("packages", ()))})
                 for n in d.get("nodes", [])]
        tasks = [SimTaskSpec(**{**t,
                                "depends_on": tuple(t.get("depends_on", ()))})
                 for t in d.get("tasks", [])]
        faults = []
        for f in d.get("faults", []):
            spec = f.get("spec")
            if isinstance(spec, dict):
                spec = NodeSpec(**{**spec,
                                   "packages": tuple(spec.get("packages", ()))})
            faults.append(Fault(**{**f, "nodes": tuple(f.get("nodes", ())),
                                   "spec": spec}))
        return Scenario(seed=d["seed"], nodes=nodes, tasks=tasks,
                        faults=faults, horizon=d.get("horizon", 120.0),
                        workflows=dict(d.get("workflows", {})))

    @staticmethod
    def from_json(text: str) -> "Scenario":
        return Scenario.from_dict(json.loads(text))

    # ------------------------------------------------------------------ #
    @staticmethod
    def random(seed: int, *,
               max_nodes: int = 5,
               max_tasks: int = 24,
               task_failure_rate: float = 0.3,
               fault_rate: float = 0.5,
               with_workflows: bool = True,
               crash_rate: float = 0.2,
               correlated_rate: float = 0.0,
               horizon: float = 120.0) -> "Scenario":
        """Sample a chaos scenario; every choice flows from the seed.

        The sampled cluster always keeps at least one fully-healthy node
        (no fault ever targets it) so the paper's *resolvable* failures
        stay resolvable — assertable properties need a floor of
        feasibility.  A big-memory node, a ``wrathpkg`` node and a raised
        ulimit appear with fixed probabilities so each spec-modification
        behaviour is sometimes fixable by re-placement and sometimes
        genuinely infeasible.

        ``correlated_rate > 0`` additionally samples the correlated-outage
        kinds (zone loss, data/heartbeat partition, spot mass-preemption,
        elastic join/leave) and a cascading-OOM task chain whose
        ``memory_gb`` demand doubles along a dependency chain.  The block
        is fully gated: at the default 0.0 no extra RNG draws happen, so
        pre-existing seeds keep their byte-identical traces.
        """
        rng = random.Random(seed)
        n_nodes = rng.randint(2, max_nodes)
        nodes: list[NodeSpec] = []
        for i in range(n_nodes):
            nodes.append(NodeSpec(
                name=f"sim-n{i:02d}",
                memory_gb=rng.choice([16.0, 64.0, 192.0, 192.0]),
                speed=rng.choice([1.0, 1.0, 1.0, 0.25]),
                workers=rng.randint(1, 2)))
        if rng.random() < 0.5:          # §VII-C big-memory escalation target
            nodes.append(NodeSpec(name=f"sim-n{n_nodes:02d}",
                                  memory_gb=6144.0))
        if rng.random() < 0.4:          # with-package pool analog
            nodes.append(NodeSpec(name=f"sim-pkg{len(nodes):02d}",
                                  packages=("numpy", "jax", "wrathpkg")))
        if rng.random() < 0.3:          # raised-ulimit node
            nodes.append(NodeSpec(name=f"sim-fd{len(nodes):02d}",
                                  ulimit_files=2_000_000))

        workflows: dict[str, str] = {}
        wf_name: str | None = None
        wf_members: set[int] = set()
        n_tasks = rng.randint(6, max_tasks)
        if with_workflows and rng.random() < 0.5:
            wf_name = "chaos-scope"
            workflows[wf_name] = rng.choice(["none", "none", "siblings"])
            lo = rng.randrange(max(1, n_tasks // 2))
            wf_members = set(range(lo, min(n_tasks, lo + rng.randint(2, 6))))

        tasks: list[SimTaskSpec] = []
        t = 0.0
        for i in range(n_tasks):
            t += rng.uniform(0.0, horizon / (4 * n_tasks))
            fail = None
            if rng.random() < task_failure_rate:
                fail = rng.choice(TASK_FAILURE_KINDS)
            deps: tuple[int, ...] = ()
            if i > 0 and rng.random() < 0.3:
                deps = tuple(sorted(rng.sample(
                    range(i), k=min(i, rng.randint(1, 2)))))
            tasks.append(SimTaskSpec(
                at=round(t, 6), name=f"t{i:03d}",
                duration=round(rng.uniform(0.01, 2.0), 6),
                fail=fail,
                memory_gb=rng.choice([0.5, 1.0, 4.0]),
                depends_on=deps,
                workflow=wf_name if i in wf_members else None))

        faults: list[Fault] = []
        # node 0 is the guaranteed-healthy floor: never targeted
        for spec in nodes[1:]:
            if rng.random() >= fault_rate:
                continue
            kind = rng.choice(["node_down", "hb_pause", "worker_kill",
                               "drain"])
            at = round(rng.uniform(0.1, horizon / 3), 6)
            faults.append(Fault(at=at, kind=kind, node=spec.name))
            if kind == "node_down" and rng.random() < 0.5:
                faults.append(Fault(at=round(at + rng.uniform(1.0, 10.0), 6),
                                    kind="node_up", node=spec.name))
            elif kind == "hb_pause":
                faults.append(Fault(at=round(at + rng.uniform(0.5, 5.0), 6),
                                    kind="hb_resume", node=spec.name))
            elif kind == "drain" and rng.random() < 0.5:
                faults.append(Fault(at=round(at + rng.uniform(0.5, 5.0), 6),
                                    kind="undrain", node=spec.name))
        if wf_name is not None and rng.random() < 0.5:
            faults.append(Fault(at=round(rng.uniform(0.1, horizon / 3), 6),
                                kind="cancel_workflow", workflow=wf_name))
        if rng.random() < crash_rate:
            # whole-engine crash/restart: the harness rebuilds the DFK
            # against the same TaskStore and replays the script — only the
            # incomplete frontier should re-execute
            faults.append(Fault(at=round(rng.uniform(0.5, horizon / 3), 6),
                                kind="engine_crash"))
        if correlated_rate > 0.0:
            # correlated outages; node 0 stays the untouchable floor
            pool = [n.name for n in nodes[1:]]
            if len(pool) >= 2 and rng.random() < correlated_rate:
                zone = tuple(sorted(rng.sample(pool,
                                               rng.randint(2, min(3, len(pool))))))
                at = round(rng.uniform(0.1, horizon / 3), 6)
                faults.append(Fault(at=at, kind="zone_down", nodes=zone))
                if rng.random() < 0.7:
                    faults.append(Fault(
                        at=round(at + rng.uniform(1.0, 8.0), 6),
                        kind="zone_up", nodes=zone))
            if pool and rng.random() < correlated_rate:
                victim = rng.choice(pool)
                at = round(rng.uniform(0.1, horizon / 3), 6)
                faults.append(Fault(at=at, kind="partition", node=victim))
                # partitions always heal: a permanent one is node loss,
                # which node_down already covers
                faults.append(Fault(at=round(at + rng.uniform(0.5, 6.0), 6),
                                    kind="partition_heal", node=victim))
            if rng.random() < correlated_rate:
                faults.append(Fault(
                    at=round(rng.uniform(0.1, horizon / 3), 6),
                    kind="mass_preempt",
                    fraction=round(rng.uniform(0.25, 0.75), 2)))
            if rng.random() < correlated_rate:
                spec = NodeSpec(name=f"sim-el{len(nodes):02d}",
                                memory_gb=rng.choice([64.0, 192.0]),
                                workers=rng.randint(1, 2))
                join_at = round(rng.uniform(0.1, horizon / 3), 6)
                faults.append(Fault(at=join_at, kind="node_join", spec=spec))
                if rng.random() < 0.5:
                    faults.append(Fault(
                        at=round(join_at + rng.uniform(1.0, 8.0), 6),
                        kind="node_leave", node=spec.name))
            if pool and rng.random() < correlated_rate * 0.5:
                faults.append(Fault(
                    at=round(rng.uniform(0.1, horizon / 3), 6),
                    kind="node_leave", node=rng.choice(pool)))
            if rng.random() < correlated_rate:
                # cascading OOM: a dependency chain whose memory demand
                # doubles hop over hop — early hops fit anywhere, later
                # hops only on the big-memory node (if one exists), so
                # pressure propagates down the DAG exactly like a real
                # memory amplification cascade
                base = len(tasks)
                mem = rng.choice([1.0, 2.0])
                start = round(rng.uniform(0.1, horizon / 4), 6)
                for j in range(rng.randint(3, 6)):
                    tasks.append(SimTaskSpec(
                        at=round(start + 0.05 * j, 6), name=f"oomc{j:02d}",
                        duration=round(rng.uniform(0.01, 0.5), 6),
                        memory_gb=mem,
                        depends_on=(base + j - 1,) if j else ()))
                    mem *= 2.0
        faults.sort(key=lambda f: (f.at, f.kind, f.node or "", f.workflow or ""))
        return Scenario(seed=seed, nodes=nodes, tasks=tasks, faults=faults,
                        horizon=horizon, workflows=workflows)


def _task_failure_probe() -> dict[str, Any]:  # pragma: no cover - debug aid
    """Tiny introspection helper: which injected kinds exist."""
    return {"fn_replacement": sorted(FN_REPLACEMENT),
            "spec_modification": sorted(SPEC_MODIFICATION)}
