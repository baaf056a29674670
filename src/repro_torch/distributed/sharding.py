"""Sharding-rule engine: logical axes → mesh axes with divisibility fallback
(the port of ``repro.distributed.sharding``).

Models annotate parameters (via ParamDef.axes) and activations (via
``models.layers.constrain``) with *logical* axis names.  A
:class:`ShardingRules` table maps each logical name to an ordered
preference of mesh-axis tuples; the engine picks, per tensor, the first
candidate whose mesh-axis product divides the dimension and whose axes are
not already claimed by another dimension of the same tensor.  This is what
makes one rule table work across all 10 architectures and every degraded
(elastic) mesh.

Default layout (2-D/3-D mesh, axes ``pod``/``data``/``model``):

* parameters — FSDP over (pod, data) on the ``d_model`` dim and tensor
  parallelism over ``model`` on heads / d_ff / experts / vocab;
* activations — batch over (pod, data), heads/d_ff/experts/vocab over
  ``model``;
* decode caches — batch over (pod, data) with ``seq`` over ``model`` so
  single-sequence long-context decode still spreads across chips.

Where the reference builds a ``NamedSharding`` from a ``PartitionSpec``,
the port turns the spec into DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh`` (:func:`placements_for`): a
dim sharded over (``pod``, ``data``) is ``Shard(dim)`` on both mesh dims,
in mesh order.  :func:`spec_for` reads a mesh's axis names and sizes from a
``DeviceMesh`` or from any object with ``axis_names`` and ``devices.shape``
(the reference's meshes and its tests' shape-only stand-ins).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.spec import ParamDef, is_def, tree_map, tree_zip_map

Candidate = tuple[str, ...]          # one mesh-axis combination
Preference = tuple[Candidate, ...]   # ordered fallbacks


class PartitionSpec(tuple):
    """The port's ``PartitionSpec``: one entry per dim, each a mesh-axis
    name, a tuple of them, or None (replicated); trailing Nones dropped."""

    def __new__(cls, *parts: str | tuple[str, ...] | None) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"



@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> ordered candidates (first feasible wins)."""

    rules: dict[str, Preference]

    def lookup(self, name: str | None) -> Preference:
        if name is None:
            return ()
        return self.rules.get(name, ())

    def replace(self, **upd: Preference) -> "ShardingRules":
        d = dict(self.rules)
        d.update(upd)
        return ShardingRules(d)


def _mk(*cands: tuple[str, ...]) -> Preference:
    return tuple(cands)


# fsdp = (pod, data) when multi-pod; the engine prunes absent axes.
PARAM_RULES = ShardingRules({
    "d_model": _mk(("pod", "data"), ("data",)),
    "d_ff": _mk(("model",)),
    "heads": _mk(("model",)),
    "kv_heads": _mk(("model",)),
    "experts": _mk(("model",)),
    "vocab": _mk(("model",)),
    "layers": (),                    # never shard the stacked-layer axis
})

ACT_RULES = ShardingRules({
    "batch": _mk(("pod", "data"), ("data",)),
    "seq": (),
    # residual stream between blocks ("seq_res"): Megatron-SP-style
    # sequence sharding over the TP axis was measured and refuted for the
    # reference's stack: the shard_map MoE needs model-replicated tokens at
    # entry, so SP inserted gather/reshard pairs that grew collective time.
    # Left unsharded.
    "seq_res": (),
    "d_model": (),
    "d_ff": _mk(("model",)),
    "heads": _mk(("model",)),
    "kv_heads": _mk(("model",)),
    "experts": _mk(("model",)),
    "vocab": _mk(("model",)),
})

CACHE_RULES = ShardingRules({
    "batch": _mk(("pod", "data"), ("data",)),
    "seq": _mk(("model",)),          # long-context: spread the KV/latent cache
    "kv_heads": (),                  # seq sharding beats head sharding for caches
    "heads": _mk(("model",)),        # ssd/rglru state heads
    "d_ff": _mk(("model",)),
    "d_model": (),
})


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of a reference-style mesh
    (``axis_names`` and ``devices.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(shape: tuple[int, ...], axes: tuple[str | None, ...],
             rules: ShardingRules, mesh: Any) -> PartitionSpec:
    """Pick a PartitionSpec: first feasible candidate per dim, no axis reuse."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for dim, name in zip(shape, axes):
        chosen: Candidate | None = None
        for cand in rules.lookup(name):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                chosen = cand
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements_for(spec: PartitionSpec, ndim: int, mesh: Any) -> list:
    """DTensor placements (one per mesh dim) of a tensor of ``ndim`` dims
    laid out as ``spec``: ``Shard(d)`` on each mesh dim that tensor dim d
    is sharded over, ``Replicate()`` on the others.  A dim over several
    mesh axes is sharded over them in mesh order, as JAX lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(tuple(spec)[:ndim]):
        for a in ((part,) if isinstance(part, str) else part or ()):
            out[names.index(a)] = Shard(d)
    return out


def defs_pspecs(defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """ParamDef tree -> PartitionSpec tree."""
    return tree_map(lambda d: spec_for(d.shape, d.axes, rules, mesh), defs, is_def)


def defs_placements(defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """ParamDef tree -> tree of DTensor placement lists over ``mesh``."""
    return tree_map(lambda d: placements_for(spec_for(d.shape, d.axes, rules, mesh),
                                             len(d.shape), mesh), defs, is_def)


def local_shape(shape: tuple[int, ...], placements: list, mesh: Any) -> tuple[int, ...]:
    """Each rank's shard of a tensor of ``shape``: every dim divided by the
    mesh dims it is sharded over (:func:`spec_for` only shards evenly)."""
    sizes = list(mesh_sizes(mesh).values())
    out = list(shape)
    for n, pl in zip(sizes, placements):
        if pl.is_shard():
            out[pl.dim] //= n
    return tuple(out)


def _on_mesh(local: torch.Tensor, shape: tuple[int, ...], placements: list,
             mesh: Any) -> Any:
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute_defs(defs: Any, rules: ShardingRules, mesh: Any,
                    device: str | torch.device = "meta") -> Any:
    """ParamDef tree -> DTensors laid out by ``rules``, each rank holding
    an uninitialised shard on ``device`` (``meta``: no allocation, the
    dry-run's abstract inputs)."""

    def one(d: ParamDef):
        pl = placements_for(spec_for(d.shape, d.axes, rules, mesh), len(d.shape), mesh)
        local = torch.empty(local_shape(d.shape, pl, mesh), dtype=d.dtype, device=device)
        return _on_mesh(local, d.shape, pl, mesh)

    return tree_map(one, defs, is_def)


def distribute_params(params: Any, defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """Whole tensors (from ``materialize`` or ``bridge``, the same on every
    rank) -> DTensors laid out by ``rules`` for ``defs``' logical axes,
    matched by dict key and list index: each rank keeps its shard (no
    collective: every rank holds the whole)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t: torch.Tensor, d: ParamDef):
        pl = placements_for(spec_for(d.shape, d.axes, rules, mesh), t.dim(), mesh)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return tree_zip_map(one, params, defs)


def distribute_like(t: torch.Tensor, axes: tuple[str | None, ...], rules: ShardingRules,
                    mesh: Any) -> Any:
    """One whole tensor, the same on every rank -> a DTensor laid out by
    ``rules`` for ``axes`` (each rank keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements_for(spec_for(t.shape, axes, rules, mesh),
                                                     t.dim(), mesh), src_data_rank=None)


def make_constrain_fn(mesh: Any, rules: ShardingRules):
    """The activation-sharding hook installed via models.layers.set_shard_fn:
    a DTensor is redistributed to the layout ``rules`` give its logical
    axes; a plain tensor passes unchanged."""
    from torch.distributed.tensor import DTensor

    def constrain(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
        if len(axes) != x.dim() or not isinstance(x, DTensor):
            return x
        pl = placements_for(spec_for(tuple(x.shape), axes, rules, mesh), x.dim(), mesh)
        return x if list(x.placements) == pl else x.redistribute(mesh, pl)

    return constrain


class activation_sharding:
    """Context manager installing the activation-constraint hook, with the
    mesh (and rules) for code that needs explicit collectives.  Plain
    tensors that the model builds inside (positions, masks) meet the
    DTensors as replicated ones."""

    def __init__(self, mesh: Any, rules: ShardingRules = ACT_RULES):
        self.mesh = mesh
        self.rules = rules

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.models.layers import set_shard_fn

        self._replication = implicit_replication()
        self._replication.__enter__()
        self._token = set_shard_fn(make_constrain_fn(self.mesh, self.rules),
                                   mesh=self.mesh, rules=self.rules)
        return self

    def __exit__(self, *exc):
        from repro_torch.models.layers import reset_shard_fn

        reset_shard_fn(self._token)
        self._replication.__exit__(*exc)
