"""WRATH-supervised training loop (the paper's technique on the training
plane — DESIGN.md §2).

Ports ``src/repro/train/supervisor.py``.  The control plane (cluster,
policy stack, scheduler, monitoring database, task records) is the
port's own copy; each shard's gradient is real torch compute on
``device`` (``cuda`` unless the caller asks for the CPU): ``loss_fn``
without remat and ``torch.autograd.grad`` over the parameter leaves.
One deliberate divergence: without ``start_params`` the initial weights
come from the port's seeded ``materialize``, whose numbers differ from
``jax.random``'s for the same seed.

Training is executed as a task hierarchy: each step fans out per-host
*gradient-shard tasks* over a set of virtual hosts (an
``repro_torch.engine.cluster.Cluster`` pool, so heterogeneous memory/health/speed
and the WRATH machinery come for free).  Failures raised while computing a
shard flow through the SAME composable :class:`~repro_torch.engine.policies.
PolicyStack` as the task plane (``policy=`` kwarg, WRATH by default; like
the serving plane, the supervisor drives the *decision* subset of the
protocol — ``on_submit``/``on_failure``/``review_decision`` — while
engine-execution policies such as ``replicate`` are task-plane only):

* host loss (``HardwareShutdownError``)  → denylist + hierarchical retry
  of the lost shard on another host; subsequent steps re-mesh elastically
  (the global batch is re-split over the surviving hosts);
* resource starvation (shard too big for the host) → feasibility-aware
  placement onto a big-memory host (retry ladder rung 1/4);
* NaN/Inf loss (``NumericalDivergenceError``, application layer) →
  restore the last committed checkpoint and continue with a perturbed
  data order (retriable-in-place, like the paper's Random Seed Errors);
* stragglers → speculative re-execution of the slow shard on the fastest
  healthy host (history-informed placement, §V-B rung 3).

All recovery decisions are recorded; ``TrainReport`` summarizes recovery
counts, checkpoint restores, and the loss trace (tests assert the loss
still goes down through failures).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import MonitoringDatabase
from repro_torch.core.failures import (
    FailureReport,
    HardwareShutdownError,
    NumericalDivergenceError,
)
from repro_torch.data import batch_for
from repro_torch.device import resolve_device
from repro_torch.distributed.step import batch_to, loss_and_grads
from repro_torch.engine.cluster import Cluster, Node, ResourcePool
from repro_torch.engine.policies import PolicyStack, WrathPolicy, normalize_policies
from repro_torch.engine.retry_api import Action, SchedulingContext
from repro_torch.engine.scheduler import Scheduler
from repro_torch.engine.task import ResourceSpec, TaskDef, new_task_record
from repro_torch.models import materialize, param_defs
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import tree_map, tree_zip_map
from repro_torch.optim import OptConfig, adamw_apply, init_opt_state


@dataclasses.dataclass
class TrainEvent:
    """Injected failure for a given step (training-plane fail engine)."""

    step: int
    kind: str    # host_down | host_up | nan | straggler | host_join | host_leave
    host: str | None = None
    factor: float = 5.0        # straggler slowdown
    memory_gb: float = 192.0   # joining host's capacity (host_join)


@dataclasses.dataclass
class TrainReport:
    steps_completed: int
    losses: list[float]
    recoveries: list[dict]
    restores: int
    denylisted: list[str]
    speculations: int
    final_hosts: int

    @property
    def recovered_all(self) -> bool:
        return all(r["action"] != "fail" for r in self.recoveries)


class WrathTrainSupervisor:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: OptConfig,
        *,
        n_hosts: int = 4,
        big_host: bool = True,
        host_memory_gb: float = 16.0,
        global_batch: int = 8,
        seq_len: int = 64,
        ckpt_dir: str | None = None,
        ckpt_every: int = 10,
        shard_memory_gb: float = 1.0,
        data_seed: int = 0,
        straggler_factor: float = 3.0,
        scheduler: Scheduler | None = None,
        policy: object = None,
        profile_shard_sizing: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.data_seed = data_seed
        self.shard_memory_gb = shard_memory_gb
        self.straggler_factor = straggler_factor
        self.profile_shard_sizing = profile_shard_sizing

        nodes = [Node(f"host{i:02d}", memory_gb=host_memory_gb,
                      workers_per_node=1) for i in range(n_hosts)]
        if big_host:
            nodes.append(Node("bighost", memory_gb=host_memory_gb * 32,
                              workers_per_node=1))
        self.cluster = Cluster([ResourcePool("pod0", nodes)])
        self.monitor = MonitoringDatabase()
        # composable resilience stack (task-hierarchy API): shard-failure
        # decisions flow through the same middleware protocol as the task
        # plane — first decisive decision wins.  policy=None -> WRATH
        # default; an explicit [] means Parsl-style baseline retry only
        self.policies = PolicyStack(
            normalize_policies(policy) if policy is not None
            else (WrathPolicy(),),
            on_error=self._policy_error)
        # optional placement policy: when set, shard->host assignment and
        # speculation targets go through the scheduler interface (None
        # keeps the legacy fixed-order assignment + EMA-fastest targets)
        self.scheduler = scheduler.bind(cluster=self.cluster,
                                        monitor=self.monitor) \
            if scheduler is not None else None
        self.denylist: set[str] = set()
        if ckpt_dir is None:   # the reference's /tmp/wrath_ckpt, under $TMPDIR
            ckpt_dir = os.path.join(tempfile.gettempdir(), "wrath_ckpt")
        self.ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=False)
        self.ckpt_every = ckpt_every

        self._host_times: dict[str, float] = {}
        self._slow_counts: dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def _policy_error(self, hook: str, err: BaseException) -> None:
        """Swallowed policy-hook exceptions stay visible as system events."""
        self.monitor.record_system_event(
            "policy_error", event=hook, error=type(err).__name__,
            message=str(err))

    def _ctx(self) -> SchedulingContext:
        return SchedulingContext(cluster=self.cluster, monitor=self.monitor,
                                 denylist=self.denylist, default_pool="pod0",
                                 scheduler=self.scheduler)

    def healthy_hosts(self) -> list[Node]:
        return [n for n in self.cluster.pools["pod0"].nodes
                if n.healthy and n.name not in self.denylist
                and n.name != "bighost"]

    def _order_hosts(self, hosts: list[Node]) -> list[Node]:
        """Shard->host assignment order for one step.

        With a scheduler bound, hosts are drained through repeated
        ``select`` calls — ``np.array_split`` hands earlier hosts the
        larger shards, so e.g. a history-aware scheduler steers the bigger
        sub-batches onto historically fast hosts.  Without one, pool order
        is kept (legacy behaviour).
        """
        if self.scheduler is None or len(hosts) <= 1:
            return hosts
        probe = new_task_record(
            TaskDef(lambda: None, "grad_shard",
                    ResourceSpec(memory_gb=self.shard_memory_gb), 0),
            (), {}, default_retries=0)
        pool = self.cluster.pools["pod0"]
        remaining, ordered = list(hosts), []
        while remaining:
            pick = self.scheduler.select(probe, remaining, pool=pool)
            pick = pick if pick is not None else remaining[0]
            ordered.append(pick)
            remaining.remove(pick)
        return ordered

    def _shard_sizes(self, hosts: list[Node]) -> list[int]:
        """Per-host shard sizes for one step.

        With ``profile_shard_sizing`` the monitoring database's streaming
        duration profiles size each host's sub-batch proportionally to its
        observed throughput (1 / mean shard duration): fast hosts get more
        samples, chronic stragglers get fewer — but every host keeps at
        least one sample so its profile stays fresh and the chronic-
        straggler machinery still observes it.  Hosts without enough
        history (< 3 shards) get the mean observed rate.  Falls back to the
        uniform ``np.array_split`` sizes while no history exists.
        """
        n = len(hosts)
        uniform = [len(a) for a in
                   np.array_split(np.arange(self.global_batch), n)]
        if (not self.profile_shard_sizing or n <= 1
                or self.global_batch < n):
            return uniform
        rates: list[float | None] = []
        for h in hosts:
            stats = self.monitor.duration_stats("grad_shard", node=h.name)
            rates.append(1.0 / max(stats.mean, 1e-6)
                         if stats is not None and stats.n >= 3 else None)
        known = [r for r in rates if r is not None]
        if not known:
            return uniform
        fill = sum(known) / len(known)
        weights = [r if r is not None else fill for r in rates]
        # floor of 1 sample per host, remainder by largest-remainder quota
        spare = self.global_batch - n
        total = sum(weights)
        quotas = [spare * w / total for w in weights]
        sizes = [1 + int(q) for q in quotas]
        leftover = self.global_batch - sum(sizes)
        order = sorted(range(n), key=lambda i: quotas[i] - int(quotas[i]),
                       reverse=True)
        for i in order[:leftover]:
            sizes[i] += 1
        return sizes

    # ------------------------------------------------------------------ #
    def _grad_fn(self, params, batch):
        """(loss, grads) of one shard: the reference's
        ``value_and_grad(loss_fn(remat=False))``."""
        loss, _, grads = loss_and_grads(params, batch_to(batch, self.device), self.cfg,
                                        remat=False)
        return loss, grads

    def _shard_task(self, step: int, host: Node, params, batch,
                    injected_nan: bool):
        """Compute one host's gradient shard (real torch compute), raising
        the failures a real host would raise."""
        if not host.healthy:
            raise HardwareShutdownError(f"host {host.name} is down",
                                        node=host.name)
        if self.shard_memory_gb > host.memory_gb:
            raise MemoryError(
                f"cannot allocate {self.shard_memory_gb}GB on {host.name} "
                f"(capacity {host.memory_gb}GB)")
        if host.speed < 1.0:
            time.sleep(min(0.05 / host.speed, 0.5))  # simulated straggle
        loss, grads = self._grad_fn(params, batch)
        if injected_nan:
            loss = loss * float("nan")
            grads = tree_map(lambda g: g * float("nan"), grads)
        if not bool(torch.isfinite(loss)):
            raise NumericalDivergenceError(
                f"loss is NaN/Inf at step {step}", node=host.name)
        return float(loss), grads

    def _profile(self, host: Node) -> dict[str, float]:
        return {"node_memory_gb": host.memory_gb,
                "node_mem_in_use_gb": host.mem_in_use_gb,
                "node_healthy": float(host.healthy)}

    # ------------------------------------------------------------------ #
    def run(self, steps: int, *, events: list[TrainEvent] | None = None,
            start_params=None) -> TrainReport:
        events = events or []
        by_step: dict[int, list[TrainEvent]] = {}
        for e in events:
            by_step.setdefault(e.step, []).append(e)

        params = start_params if start_params is not None \
            else materialize(param_defs(self.cfg), self.data_seed, self.device)
        opt_state = init_opt_state(params, self.opt_cfg)
        step0 = 0
        restored = self.ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            tree, meta = restored
            params, opt_state = tree["params"], tree["opt"]
            step0 = int(meta["step"]) + 1

        losses: list[float] = []
        recoveries: list[dict] = []
        restores = 0
        speculations = 0
        data_jitter = 0
        step = step0
        while step < steps:
            # -- injected environment events (one-shot: a rewound run must
            # not re-trigger the same injected fault) ----------------------
            step_events = by_step.pop(step, [])
            for ev in step_events:
                node = self.cluster.find_node(ev.host) if ev.host else None
                if ev.kind == "host_down" and node:
                    node.shutdown_hardware()
                elif ev.kind == "host_up" and node:
                    node.restore_hardware()
                    self.denylist.discard(node.name)
                elif ev.kind == "straggler" and node:
                    node.speed = 1.0 / ev.factor
                elif ev.kind == "host_join" and ev.host and node is None:
                    # elastic scale-out: the next step's shard plan is
                    # recomputed from the live host list, so the joiner
                    # picks up a sub-batch immediately — no restart
                    self.cluster.pools["pod0"].add_node(
                        Node(name=ev.host, memory_gb=ev.memory_gb))
                    self.monitor.record_system_event("host_join",
                                                     node=ev.host)
                elif ev.kind == "host_leave" and node:
                    # elastic scale-in: remove from membership entirely
                    # (unlike host_down the host is *gone*, not unhealthy)
                    # and reshard the remaining global batch live
                    self.cluster.pools["pod0"].remove_node(ev.host)
                    self.denylist.discard(ev.host)
                    self.monitor.record_system_event("host_leave",
                                                     node=ev.host)

            inject_nan = any(e.kind == "nan" for e in step_events)

            hosts = self._order_hosts(
                self.healthy_hosts() or [self.cluster.find_node("bighost")])
            batch = batch_for(self.cfg, self.global_batch, self.seq_len,
                              step + data_jitter, seed=self.data_seed)
            sizes = self._shard_sizes(hosts)
            edges = np.cumsum([0] + sizes)
            shards = [np.arange(edges[i], edges[i + 1])
                      for i in range(len(hosts))]

            grads_acc = None
            loss_acc = 0.0
            nshards = 0
            restart_step = False
            for host, idx in zip(hosts, shards):
                if len(idx) == 0:
                    continue
                sub = {k: v[idx] for k, v in batch.items()}
                attempt_host: Node | None = host
                rec = new_task_record(
                    TaskDef(lambda: None, "grad_shard",
                            ResourceSpec(memory_gb=self.shard_memory_gb), 2),
                    (), {}, default_retries=2)
                # full middleware protocol: on_submit lets policies set up
                # per-record state (e.g. deferred replay's budget extension)
                self.policies.on_submit(rec, self._ctx())
                while attempt_host is not None:
                    t0 = time.perf_counter()
                    try:
                        loss, grads = self._shard_task(
                            step, attempt_host, params, sub,
                            inject_nan and nshards == 0)
                        dt = time.perf_counter() - t0
                        self.monitor.record_task_placement(
                            "grad_shard", attempt_host.name, "pod0", ok=True,
                            duration=dt, memory_gb=self.shard_memory_gb)
                        # straggler detection: EMA of *per-sample* shard
                        # times — profile-weighted sizing hands fast hosts
                        # bigger shards, so raw durations no longer compare
                        per = dt / max(len(idx), 1)
                        ema = self._host_times.get(attempt_host.name, per)
                        self._host_times[attempt_host.name] = 0.7 * ema + 0.3 * per
                        median = float(np.median(list(self._host_times.values())))
                        if per > self.straggler_factor * max(median, 1e-4) \
                                and len(hosts) > 1:
                            # rung-3 style: speculatively redo on the
                            # historically fastest host (or wherever the
                            # bound scheduler points)
                            others = [h for h in hosts
                                      if h.name != attempt_host.name]
                            fastest = None
                            if self.scheduler is not None:
                                fastest = self.scheduler.select(
                                    rec, others,
                                    pool=self.cluster.pools["pod0"])
                            if fastest is None:
                                fastest = min(
                                    others,
                                    key=lambda h: self._host_times.get(h.name, 1e9))
                            loss, grads = self._shard_task(
                                step, fastest, params, sub, False)
                            speculations += 1
                            n_slow = self._slow_counts.get(attempt_host.name, 0) + 1
                            self._slow_counts[attempt_host.name] = n_slow
                            if n_slow >= 3:
                                # chronic straggler: denylist the host (it
                                # resumes via the heartbeat-resume rule once
                                # its speed recovers)
                                self.denylist.add(attempt_host.name)
                                self.monitor.record_system_event(
                                    "denylist_add", node=attempt_host.name,
                                    cause="chronic_straggler")
                        break
                    except Exception as err:  # noqa: BLE001
                        rec.record_attempt(
                            node=attempt_host.name, pool="pod0", worker="-",
                            ok=False, error=type(err).__name__,
                            duration=time.perf_counter() - t0)
                        report = FailureReport.from_exception(
                            err, task_id=rec.task_id, node=attempt_host.name,
                            pool="pod0",
                            resource_profile=self._profile(attempt_host),
                            requirements=rec.resources.asdict(),
                            retry_count=rec.retry_count)
                        self.monitor.record_task_placement(
                            "grad_shard", attempt_host.name, "pod0", ok=False)
                        decision = self.policies.decide(rec, report, self._ctx())
                        recoveries.append({
                            "step": step, "error": type(err).__name__,
                            "host": attempt_host.name,
                            "action": decision.action.value,
                            "rung": decision.rung, "reason": decision.reason})
                        if isinstance(err, NumericalDivergenceError):
                            # application-layer divergence: restore last
                            # checkpoint, perturb the data order, re-run
                            restart_step = True
                            break
                        if decision.action in (Action.RETRY,
                                               Action.RESTART_AND_RETRY):
                            rec.retry_count += 1
                            if decision.target_node:
                                attempt_host = self.cluster.find_node(
                                    decision.target_node)
                            else:
                                # un-pinned retry (e.g. replay(n)): move to
                                # another healthy host when one exists
                                failed = attempt_host.name
                                others = [h for h in self.healthy_hosts()
                                          if h.name != failed]
                                attempt_host = (others[0] if others else
                                                (self.healthy_hosts() or [None])[0])
                        else:
                            attempt_host = None
                if restart_step:
                    break
                if attempt_host is None:
                    raise RuntimeError(
                        f"shard for step {step} unrecoverable; aborting run")
                loss_acc += loss * len(idx)
                grads = tree_map(
                    lambda g: g.to(torch.float32) * (len(idx) / self.global_batch),
                    grads)
                grads_acc = grads if grads_acc is None else tree_zip_map(
                    torch.add, grads_acc, grads)
                nshards += 1

            if restart_step:
                restored = self.ckpt.restore_latest(
                    {"params": params, "opt": opt_state})
                restores += 1
                data_jitter += 1          # perturb data order (reseed)
                if restored is not None:
                    tree, meta = restored
                    params, opt_state = tree["params"], tree["opt"]
                    step = int(meta["step"]) + 1
                continue

            params, opt_state, _ = adamw_apply(params, grads_acc, opt_state,
                                               self.opt_cfg)
            losses.append(loss_acc / self.global_batch)
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
            step += 1

        self.ckpt.save(steps - 1, {"params": params, "opt": opt_state})
        return TrainReport(
            steps_completed=len(losses), losses=losses, recoveries=recoveries,
            restores=restores, denylisted=sorted(self.denylist),
            speculations=speculations, final_hosts=len(self.healthy_hosts()))
