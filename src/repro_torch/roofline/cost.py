"""The cost of one eager step: FLOPs, HBM bytes, collectives, and the
port's Hopper kernels credited per launch (the port of
``repro.roofline.hlo_cost``).

The reference parses a compiled XLA module and rolls its instructions up
by trip count.  The port runs eagerly, so :func:`count_step` runs one
step and counts what it dispatches:

* **FLOPs** of aten ops: ``torch.utils.flop_counter``'s per-op formulas
  (matrix products and convolutions, forward and backward), applied by
  the same dispatch mode that counts bytes.
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
  :func:`attention_bound`, :func:`attention_bwd_bound`, :func:`ssd_bound`
  and :func:`ssd_bwd_bound`, which ``chip_smoke.py`` uses for its bounds
  too.
  A kernel's credited bytes are its inputs read once and its outputs
  written once; its scores never reach HBM, so it adds nothing to
  ``attn_score_bytes``.

Under a mesh every count is **per device**: the mode passes each DTensor
op on (``NotImplemented``), so it sees the ops that DTensor runs on this
rank's local shards, and the functional collectives of its
redistributions; the shape propagation DTensor runs on fake tensors is
left out.  ``FlopCounterMode`` itself would see the DTensor op and count
the whole mesh's work.  The kernels run on local shards too
(``local_map``), so their credits are per device.

* **Peak bytes**: the most bytes that storages the step allocated (its
  activations, gradients, collective buffers and outputs, not the
  arguments :func:`count_step` was given) held at once.  PyTorch keeps a
  storage's Python object alive as long as the storage, so a finalizer on
  it runs when its last holder (a view, a tensor saved for the backward)
  lets go; the count is exact for any device, ``meta`` included, up to
  the allocator's rounding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

#: peak FLOP/s by the dtype's name, as the kernels' bounds read it
PEAK_FLOPS = {"torch.bfloat16": PEAK_FLOPS_BF16, "torch.float16": PEAK_FLOPS_BF16,
              "torch.float32": PEAK_FLOPS_F32}
#: bytes an element by the dtype's name
_ELEM_BYTES = {"torch.bfloat16": 2, "torch.float16": 2}
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
    es = _ELEM_BYTES.get(dtype, 4)
    nbytes = float(es * (b * s * h * (dk + dv) + b * sk * kv * (dk + dv)))   # q, o, k, v
    return _bound(flops, nbytes, dtype)


def attention_bwd_bound(b: int, s: int, h: int, kv: int, d: int, dtype, causal: bool,
                        window: int, *, dv: int | None = None,
                        sk: int | None = None) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of the attention gradient on these
    inputs: S queries over Sk keys (default S), q/k head dim d, v (and o)
    head dim dv (default d).  Five products over the visible pairs, 2 FLOPs
    a MAC: q k and dS k and dS^T q over d, dO v and P^T dO over dv; q, o,
    dO, k, v and the three gradients moved once, and lse."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = visible_pairs(s, sk, causal, window)
    flops = 2.0 * b * h * (3 * d + 2 * dv) * pairs
    es = _ELEM_BYTES.get(dtype, 4)
    nbytes = float(es * (2 * b * s * h * (d + dv) + 2 * b * sk * kv * (d + dv)) + 4 * b * h * s)
    return _bound(flops, nbytes, dtype)


def attention_bwd_dq_bound(b: int, s: int, h: int, kv: int, d: int, dtype, causal: bool,
                           window: int, *, dv: int | None = None,
                           sk: int | None = None) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of the attention gradient's dQ
    kernel alone on these inputs (as :func:`attention_bwd_bound`): three
    products over the visible pairs, 2 FLOPs a MAC, q k and dS k over d and
    dO v over dv; q, k, v, o, dO and lse read once, dQ written once, and
    the Delta and base-2 lse it keeps for the dK/dV kernel (fp32, a row
    each) written once."""
    dv = d if dv is None else dv
    sk = s if sk is None else sk
    pairs = visible_pairs(s, sk, causal, window)
    flops = 2.0 * b * h * (2 * d + dv) * pairs
    es = _ELEM_BYTES.get(dtype, 4)
    nbytes = float(es * (b * s * h * (2 * d + 2 * dv) + b * sk * kv * (d + dv))
                   + 4 * 3 * b * h * s)
    return _bound(flops, nbytes, dtype)


def _es(dtype) -> int:
    return _ELEM_BYTES.get(dtype, 4)


def ssd_bound(b: int, l: int, h: int, p: int, n: int, q: int, dtype,
              a_dtype, *, g: int = 1, s0_dtype=None) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of one SSD scan on these inputs.

    FLOPs count what the function needs, 2 per MAC, chunk by chunk (the
    last one may be short): C B^T on the causal pairs only, once per
    (batch, chunk, B/C group) since a group's heads share it; per head the
    decay tile times x dt on the same pairs (P MACs a pair), C . state
    (P N MACs a step; none in the first chunk, whose carried state is zero
    unless an initial state of dtype ``s0_dtype`` is given) and the state
    update (P N MACs a step).  Bytes: x, dt, a, the G groups of b and c
    and the initial state read once, y and the final state written once."""
    pairs = steps = carried = 0
    for l0 in range(0, l, q):
        qc = min(q, l - l0)
        pairs += qc * (qc + 1) // 2
        steps += qc
        carried += qc if l0 or s0_dtype else 0
    flops = 2.0 * b * (g * pairs * n + h * (pairs * p + (carried + steps) * p * n))
    es = _es(dtype)
    nbytes = float(es * (2 * b * l * h * p + 2 * b * l * g * n + b * l * h + b * h * p * n)
                   + _es(a_dtype) * h + (_es(s0_dtype) * b * h * p * n if s0_dtype else 0))
    return _bound(flops, nbytes, dtype)


def ssd_bwd_bound(b: int, l: int, h: int, p: int, n: int, dtype, a_dtype, *,
                  tile: int = 64, g: int = 1, s0_dtype=None) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of one SSD backward on these
    inputs, tile by tile as ``csrc/ssd_scan_bwd.cu`` cuts the steps (the
    last tile may be short), 2 FLOPs a MAC.  Per (batch, tile, B/C group)
    C B^T on the causal pairs, once for the group's heads.  Per head, on
    the same pairs, dy . u and W^T dy (P MACs a pair each) and the
    intra-tile parts of dC and dB (N each); per step dS B^T and x dS (P N
    each); the carried parts, where the state is not zero (every tile but
    the first, and the first too from an initial state of dtype
    ``s0_dtype``), dy S into dC and dy^T C into dS (P N a step each); and
    the states entering every tile but the first, recomputed (P N a step:
    the first tile's is zero or the given state).  Bytes: x,
    dt, a, the G groups of b and c, dy and the initial state read once,
    dx, ddt, da, db, dc and the initial state's gradient written once."""
    pairs = steps = carried = recomputed = 0
    for l0 in range(0, l, tile):
        qc = min(tile, l - l0)
        pairs += qc * (qc + 1) // 2
        steps += qc
        carried += qc if l0 or s0_dtype else 0
        recomputed += qc if l0 else 0
    flops = 2.0 * b * (g * pairs * n + h * (pairs * (2 * p + 2 * n)
                                            + (2 * steps + 2 * carried + recomputed) * p * n))
    es = _es(dtype)
    nbytes = float(es * (3 * b * l * h * p + 2 * b * l * h + 4 * b * l * g * n)
                   + 2 * _es(a_dtype) * h
                   + (2 * _es(s0_dtype) * b * h * p * n if s0_dtype else 0))
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
                                       launch["window"], dv=dv, sk=sk)
    elif name in ("ssd_scan", "ssd_scan_bwd"):
        from repro_torch.kernels.ssd_scan import BWD_TILES

        x, bm, s0 = launch["x"], launch["b"], launch.get("initial_state")
        b, l, h, p = x.shape
        n = bm.shape[-1]
        kw = dict(g=bm.shape[2] if bm.dim() == 4 else 1,
                  s0_dtype=None if s0 is None else str(s0.dtype))
        if name == "ssd_scan":
            cost = ssd_bound(b, l, h, p, n, launch["chunk"], str(x.dtype),
                             str(launch["a"].dtype), **kw)
        else:
            cost = ssd_bwd_bound(b, l, h, p, n, str(x.dtype), str(launch["a"].dtype),
                                 tile=BWD_TILES.get((p, n), 64), **kw)
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
    peak_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(self.kernel_flops.values())

    @property
    def bytes(self) -> float:
        return self.aten_bytes + sum(self.kernel_bytes.values())

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


class _LiveBytes:
    """The bytes of the storages the counted ops allocated that are alive,
    and their peak into ``cost.peak_bytes``.  ``known``: the storages that
    were there before (the step's arguments), whose views allocate nothing."""

    def __init__(self, cost: StepCost, known: list[torch.Tensor]):
        self.cost = cost
        self.seen = {id(_storage(t)) for t in known}
        self.live = 0

    def add(self, out: Any) -> None:
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            st = _storage(t)
            if id(st) in self.seen:
                continue
            self.seen.add(id(st))
            n = st.nbytes()
            self.live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            weakref.finalize(st, self._free, id(st), n)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.seen.discard(key)


def _storage(t: torch.Tensor):
    from torch.distributed.tensor import DTensor

    return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()


class _CountMode(TorchDispatchMode):
    """Sums each dispatched local op's FLOPs and its input and output bytes
    into ``cost``, and tracks the bytes it allocates (``live``)."""

    def __init__(self, cost: StepCost, live: _LiveBytes):
        super().__init__()
        self.cost = cost
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented                  # count the local ops it runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or isinstance(out, FakeTensor):
            return out                             # DTensor's shape propagation
        self.live.add(out)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.cost.aten_flops += formula(*args, **kwargs, out_val=out)
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
def counting(inputs: Any = ()):
    """Count everything run inside: ``with counting() as cost: step()``.
    ``inputs``: the tensors the step starts from (a tree), which its peak
    bytes leave out.  One count at a time (the kernels' hook is one module
    global)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import ops

    if ops.launch_hook is not None:
        raise RuntimeError("counting: a count is already running")
    cost = StepCost()

    def credit(name: str, **launch: Any) -> None:
        flops, nbytes = kernel_cost(name, **launch)
        cost.kernel_launches[name] += 1
        cost.kernel_flops[name] += flops
        cost.kernel_bytes[name] += nbytes

    comm_mode = CommDebugMode()
    ops.launch_hook = credit
    try:
        live = _LiveBytes(cost, [t for t in tree_flatten(inputs)[0]
                                 if isinstance(t, torch.Tensor)])
        with comm_mode, _CountMode(cost, live):
            yield cost
    finally:
        ops.launch_hook = None
        cost.coll_counts = {str(op): n for op, n in comm_mode.get_comm_counts().items()}


def count_step(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[Any, StepCost]:
    """Run ``fn(*args, **kwargs)`` once under :func:`counting` (its
    arguments are the inputs the peak bytes leave out); on CUDA the step is
    synchronised before the count closes.  Returns (its result, its cost)."""
    with counting((args, kwargs)) as cost:
        result = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return result, cost
