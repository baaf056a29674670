"""Continuous (dynamic) batching: slot-structured decode state per replica.

The saxml servable-model idiom: each replica runs ONE padded decode
program at a fixed batch size (``max_batch``).  The program's cost is set
by the padding, not the occupancy, so the throughput lever is *slot
utilization*: a finished request vacates its slot at the step boundary
and the next queued request moves in immediately — no waiting for the
rest of the batch, no head-of-line blocking behind the longest request.

Two decode backends share the slot protocol:

* :class:`TorchDecodeBackend` — the real model: one device-resident KV
  cache per replica sized ``(max_batch, max_len)``, one ``decode_step``
  at the fixed shape ``(max_batch, 1)`` every step (ring-buffer cache,
  updated in place).  A request joining
  mid-flight is teacher-forced through its prompt (plus any tokens
  recovered from a lost replica) inside the shared program — the
  reproduction-scale stand-in for a prefill/generate split.
* :class:`SimDecodeBackend` — the deterministic stand-in for the
  simulation plane: tokens are a pure function of (rid, position), and
  the step *cost* is a modeled virtual duration (scaled by replica
  speed), so sustained-load and chaos scenarios run byte-identically
  under :class:`~repro.sim.VirtualClock` at microsecond wall cost.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.failures import HardwareShutdownError
from repro_torch.device import resolve_device
from repro_torch.distributed.step import build_serve_step
from repro_torch.models import cache_defs, materialize, param_defs
from repro_torch.serve.queue import ServeRequest


class ReplicaSlots:
    """Slot occupancy of one replica's in-flight continuous batch."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.slots: list[ServeRequest | None] = [None] * max_batch

    def occupants(self) -> list[ServeRequest]:
        return [r for r in self.slots if r is not None]

    def free_count(self) -> int:
        return sum(1 for r in self.slots if r is None)

    def admit(self, req: ServeRequest) -> int:
        """Seat ``req`` in the first free slot; returns the slot index."""
        for i, r in enumerate(self.slots):
            if r is None:
                # (re)start the token feed: teacher-force the prompt plus
                # everything already generated (failover recovery replays
                # recovered tokens, so no generated token is ever lost)
                req.feed = list(req.prompt) + list(req.generated)
                req.pos = 0
                req.status = "running"
                self.slots[i] = req
                return i
        raise RuntimeError("no free slot")  # pragma: no cover - guarded

    def vacate(self, i: int) -> None:
        self.slots[i] = None

    def evict_all(self) -> list[ServeRequest]:
        """Clear every slot (replica loss); returns the evicted requests."""
        out = self.occupants()
        self.slots = [None] * self.max_batch
        return out


def advance_slots(slots: ReplicaSlots, next_tokens: list[int]) -> list[ServeRequest]:
    """Apply one decode step's outputs to every occupied slot.

    ``next_tokens[i]`` is the model's prediction after consuming slot
    ``i``'s current feed token.  While the feed still has tokens ahead
    (teacher-forced prefill/replay) the prediction is discarded; once the
    feed is exhausted the prediction is the next generated token and is
    appended to both ``generated`` and the feed (it is the next step's
    input).  Returns the requests that finished this step.
    """
    finished: list[ServeRequest] = []
    for i, req in enumerate(slots.slots):
        if req is None:
            continue
        tok = next_tokens[i]
        req.pos += 1
        if req.pos >= len(req.feed) and not req.done:
            req.generated.append(int(tok))
            req.feed.append(int(tok))
        if req.done:
            finished.append(req)
            slots.vacate(i)
    return finished


class DecodeBackend:
    """Decode executor protocol shared by the real and simulated planes."""

    name = "base"

    def start_replica(self, replica: Any) -> None:
        """Allocate per-replica decode state (KV cache)."""

    def drop_replica(self, name: str) -> None:
        """Release a (lost or scaled-down) replica's decode state."""

    def step(self, replica: Any, inputs: list[int | None]) -> list[int]:
        """One decode step: per-slot input token (None = free slot) →
        per-slot next token.  Raises
        :class:`~repro.core.failures.HardwareShutdownError` if the
        replica's hardware is down."""
        raise NotImplementedError

    def step_cost_s(self, replica: Any) -> float | None:
        """Modeled step duration (virtual clocks); ``None`` = measure
        wall time (real clocks)."""
        return None


class TorchDecodeBackend(DecodeBackend):
    """Real decode: one parameter set for every replica, one resident
    cache per replica, one fixed ``(max_batch, 1)`` step.

    Ports ``repro.serve.batcher.JaxDecodeBackend``.  Runs on ``cuda``
    unless ``device="cpu"`` is passed; tests may assign carried-across
    weights to ``params``.
    """

    name = "torch"

    def __init__(self, cfg: Any, *, max_batch: int, seed: int = 0,
                 max_len: int = 64, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = materialize(param_defs(cfg), seed, self.device)
        # ONE step for every replica and every occupancy: shapes are
        # pinned to (max_batch, 1), so slot churn never changes them
        self._decode = build_serve_step(cfg)
        self._caches: dict[str, Any] = {}

    def start_replica(self, replica: Any) -> None:
        self._caches[replica.name] = materialize(
            cache_defs(self.cfg, self.max_batch, self.max_len), 0, self.device)

    def drop_replica(self, name: str) -> None:
        self._caches.pop(name, None)

    def step(self, replica: Any, inputs: list[int | None]) -> list[int]:
        if not replica.healthy:
            raise HardwareShutdownError(
                f"replica {replica.name} is down", node=replica.name)
        cache = self._caches.get(replica.name)
        if cache is None:  # pragma: no cover - start_replica guards this
            raise HardwareShutdownError(
                f"replica {replica.name} has no decode state",
                node=replica.name)
        toks = torch.zeros((self.max_batch, 1), dtype=torch.int32)
        for i, tok in enumerate(inputs):
            if tok is not None:
                toks[i, 0] = tok
        logits, cache = self._decode(self.params, cache,
                                     {"inputs": toks.to(self.device)})
        self._caches[replica.name] = cache
        return torch.argmax(logits[:, -1], dim=-1).tolist()


class SimDecodeBackend(DecodeBackend):
    """Deterministic simulated decode for ``repro.sim`` serving scenarios.

    The next token is a pure function of the input token and the slot's
    request id, so same-seed scenarios produce byte-identical token
    streams; the modeled step cost is ``step_s`` scaled down by replica
    speed (a 0.25× replica decodes 4× slower), feeding the monitoring
    profile exactly like a measured duration would.
    """

    name = "sim"

    def __init__(self, *, step_s: float = 0.02, vocab_size: int = 256):
        self.step_s = step_s
        self.vocab_size = vocab_size
        self._started: set[str] = set()

    def start_replica(self, replica: Any) -> None:
        self._started.add(replica.name)

    def drop_replica(self, name: str) -> None:
        self._started.discard(name)

    def step(self, replica: Any, inputs: list[int | None]) -> list[int]:
        if not replica.healthy:
            raise HardwareShutdownError(
                f"replica {replica.name} is down", node=replica.name)
        return [((tok * 1009 + 101) % self.vocab_size) if tok is not None
                else 0 for tok in inputs]

    def step_cost_s(self, replica: Any) -> float:
        return self.step_s / max(getattr(replica, "speed", 1.0), 1e-6)
