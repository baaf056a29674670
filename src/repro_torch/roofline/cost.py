"""The cost of one eager step: FLOPs, HBM bytes, collectives, and the
port's Hopper kernels credited per launch (the port of
``repro.roofline.hlo_cost``).

The reference parses a compiled XLA module and rolls its instructions up
by trip count.  The port runs eagerly, so :func:`count_step` runs one
step and counts what it dispatches:

* **FLOPs** of aten ops: ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products and convolutions, forward and backward).
* **Bytes**: a ``TorchDispatchMode`` sums each op's input and output
  bytes, leaving out views and bare allocations.  In eager mode every op
  reads its inputs from and writes its outputs to HBM, so this is the
  step's traffic, the counterpart of ``hlo_cost``'s fusion-naive
  ``bytes``.  A matrix product whose output or left operand holds at
  least 75% of its bytes (the scores of Q K^T or the probabilities of
  P V, in the CPU's blockwise mirror of the flash kernel) also adds that
  tensor to ``attn_score_bytes``, the traffic a flash kernel keeps on
  chip; a decode step's K or V cache is the right operand and is not.
* **Collectives** by kind and bytes: their counts from
  ``torch.distributed.tensor.debug.CommDebugMode``, their bytes from the
  same dispatch mode (the operand a rank sends; an all-reduce twice, as
  the reference counts it).  One card has none.
* **The Hopper kernels** launch through ``ctypes``, which dispatch never
  sees (a flash launch would count as one ``torch.empty``).  Each
  wrapper calls ``kernels.ops.launch_hook`` at its launch, and the count
  credits the launch with the kernel's own formulas below:
  :func:`attention_bound`, :func:`attention_bwd_bound` and
  :func:`ssd_bound`, which ``chip_smoke.py`` uses for its bounds too.
  A kernel's credited bytes are its inputs read once and its outputs
  written once; its scores never reach HBM, so it adds nothing to
  ``attn_score_bytes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

#: peak FLOP/s by the dtype's name, as the kernels' bounds read it
PEAK_FLOPS = {"torch.bfloat16": PEAK_FLOPS_BF16, "torch.float32": PEAK_FLOPS_F32}
PEAK_BYTES_S = HBM_BW


def _bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str, float, float]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def visible_pairs(s: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that no mask hides: S queries over Sk keys."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else 0
    hi = np.minimum(q + 1, sk) if causal else np.full(s, sk)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(b: int, s: int, sk: int, h: int, kv: int, dk: int, dv: int, dtype,
                    causal: bool, window: int) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) for the unmasked pairs this input
    has: S queries over Sk keys, q/k head dim dk, v (and o) head dim dv."""
    pairs = visible_pairs(s, sk, causal, window)
    flops = 2.0 * b * h * (dk + dv) * pairs           # q.k and p.v, 2 FLOPs per MAC
    es = 2 if dtype == "torch.bfloat16" else 4
    nbytes = float(es * (b * s * h * (dk + dv) + b * sk * kv * (dk + dv)))   # q, o, k, v
    return _bound(flops, nbytes, dtype)


def attention_bwd_bound(b: int, s: int, h: int, kv: int, d: int, dtype, causal: bool,
                        window: int) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of the attention gradient on these
    inputs: five products over the visible pairs (q k, dO v, P^T dO, dS k,
    dS^T q); q, k, v, o, dO and the three gradients moved once, and lse."""
    _, _, fwd_flops, _ = attention_bound(b, s, s, h, kv, d, d, dtype, causal, window)
    flops = fwd_flops * 5 / 2                          # the forward's two products are 4 D a pair
    es = 2 if dtype == "torch.bfloat16" else 4
    nbytes = float(es * (4 * b * s * h * d + 4 * b * s * kv * d) + 4 * b * h * s)
    return _bound(flops, nbytes, dtype)


def ssd_bound(b: int, l: int, h: int, p: int, n: int, q: int, dtype,
              a_dtype) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of one SSD scan on these inputs.

    FLOPs count what the function needs, 2 per MAC, chunk by chunk (the
    last one may be short): C B^T on the causal pairs only, once per
    (batch, chunk) since all heads share one B/C group; per head the
    decay tile times x dt on the same pairs (P MACs a pair), C . state
    (P N MACs a step; none in the first chunk, whose carried state is zero)
    and the state update (P N MACs a step).  Bytes: x, dt, a, b, c read
    once, y and the final state written once."""
    pairs = steps = carried = 0
    for l0 in range(0, l, q):
        qc = min(q, l - l0)
        pairs += qc * (qc + 1) // 2
        steps += qc
        carried += qc if l0 else 0
    flops = 2.0 * b * (pairs * n + h * (pairs * p + (carried + steps) * p * n))
    es = 2 if dtype == "torch.bfloat16" else 4
    a_es = 2 if a_dtype == "torch.bfloat16" else 4
    nbytes = float(es * (2 * b * l * h * p + 2 * b * l * n + b * l * h + b * h * p * n)
                   + a_es * h)
    return _bound(flops, nbytes, dtype)


def kernel_cost(name: str, **launch: Any) -> tuple[float, float]:
    """(flops, bytes) of one launch of the port's kernel ``name``, from the
    arguments its wrapper passes to ``kernels.ops.launch_hook``."""
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, v = launch["q"], launch["k"], launch["v"]
        b, s, h, dk = q.shape
        sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
        if name == "flash_attention":
            cost = attention_bound(b, s, sk, h, kv, dk, dv, str(q.dtype), launch["causal"],
                                   launch["window"])
        else:
            cost = attention_bwd_bound(b, s, h, kv, dk, str(q.dtype), launch["causal"],
                                       launch["window"])
    elif name == "ssd_scan":
        x, bm = launch["x"], launch["b"]
        b, l, h, p = x.shape
        cost = ssd_bound(b, l, h, p, bm.shape[-1], launch["chunk"], str(x.dtype),
                         str(launch["a"].dtype))
    else:
        raise ValueError(f"kernel_cost: no formula for kernel {name!r}")
    return cost[2], cost[3]


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
_ALLOCATIONS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                          "new_empty_strided", "resize_"})
#: matrix products -> the index of their left operand among their arguments
_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})
#: op-name fragment -> the reference's collective kind
_COLLECTIVE_KINDS = (("reduce_scatter", "reduce-scatter"), ("allgather", "all-gather"),
                     ("all_gather", "all-gather"), ("allreduce", "all-reduce"),
                     ("all_reduce", "all-reduce"), ("alltoall", "all-to-all"),
                     ("all_to_all", "all-to-all"), ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _tensor_bytes(tree) -> list[int]:
    leaves, _ = tree_flatten(tree)
    return [t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor)]


def _collective(name: str) -> str | None:
    for frag, kind in _COLLECTIVE_KINDS:
        if frag in name:
            return kind
    return None


@dataclasses.dataclass
class StepCost:
    """What one counted step did.  ``flops`` and ``bytes`` include the
    kernels' credits; ``aten_flops`` and ``aten_bytes`` are what dispatch
    saw alone."""
    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    attn_score_bytes: float = 0.0
    coll: dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_launches: dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    kernel_flops: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernel_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(self.kernel_flops.values())

    @property
    def bytes(self) -> float:
        return self.aten_bytes + sum(self.kernel_bytes.values())

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


class _ByteMode(TorchDispatchMode):
    """Sums each dispatched op's input and output bytes into ``cost``."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _ALLOCATIONS:
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _collective(name)
            if kind is not None:
                sizes = _tensor_bytes((args, kwargs))
                # the operand a rank sends: an all-gather's input is its
                # smallest tensor, the others' their largest
                sent = (min(sizes) if kind == "all-gather" else max(sizes)) if sizes else 0
                if kind == "all-reduce":
                    sent *= 2           # reduce-scatter + all-gather on the wire
                self.cost.coll[kind] += sent
                self.cost.aten_bytes += sent
            return out
        ins, outs = _tensor_bytes((args, kwargs)), _tensor_bytes(out)
        self.cost.aten_bytes += sum(ins) + sum(outs)
        if name in _PRODUCTS and outs:
            left = _tensor_bytes(args[_PRODUCTS[name]])
            score = max(outs + left)
            if score >= 0.75 * (sum(ins) + sum(outs)):
                self.cost.attn_score_bytes += score
        return out


@contextlib.contextmanager
def counting():
    """Count everything run inside: ``with counting() as cost: step()``.
    One count at a time (the kernels' hook is one module global)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    if ops.launch_hook is not None:
        raise RuntimeError("counting: a count is already running")
    cost = StepCost()

    def credit(name: str, **launch: Any) -> None:
        flops, nbytes = kernel_cost(name, **launch)
        cost.kernel_launches[name] += 1
        cost.kernel_flops[name] += flops
        cost.kernel_bytes[name] += nbytes

    flop_mode, comm_mode = FlopCounterMode(display=False), CommDebugMode()
    ops.launch_hook = credit
    try:
        with flop_mode, comm_mode, _ByteMode(cost):
            yield cost
    finally:
        ops.launch_hook = None
        cost.aten_flops = float(flop_mode.get_total_flops())
        cost.coll_counts = {str(op): n for op, n in comm_mode.get_comm_counts().items()}


def count_step(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[Any, StepCost]:
    """Run ``fn(*args, **kwargs)`` once under :func:`counting`; on CUDA the
    step is synchronised before the count closes.  Returns (its result,
    its cost)."""
    with counting() as cost:
        result = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return result, cost
