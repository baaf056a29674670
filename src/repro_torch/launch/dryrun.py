"""Multi-pod dry-run: every (arch × shape × mesh) cell as a meta-device
step (the port of ``repro.launch.dryrun``).

For each cell this shows the distribution is coherent without the
hardware: under a ``fake`` process group of the mesh's rank count (one
process stands for rank 0), the parameters, optimizer state, cache and
batch are built as ``meta`` DTensors laid out by the sharding rules, and
the cell's step (train: ``loss_and_grads`` and ``adamw_apply``; prefill;
or one decode step) runs once under ``activation_sharding``.  That is the
port's counterpart of ``jit(step).lower(...).compile()``: every op must
find a sharding, every redistribution becomes a functional collective,
and no byte is allocated.  The step is counted with ``roofline/``
(``count_step``) and read against the H100's datasheet constants
(``launch/mesh.py``): the numbers are counts, not measurements.

Counts are per device.  FLOPs and bytes are ``torch.utils.flop_counter``'s
per-op formulas and each op's input and output bytes, applied to the
local ops that DTensor runs on rank 0's shards (``roofline.cost``'s mode
passes each DTensor op on and sees its local ops), with the Hopper
kernels credited per launch at their shard's shapes (their wrappers'
meta branch).  The collective term is each functional collective's
operand bytes on this rank (an all-reduce twice), as the reference counts
HLO collectives.

Memory, per device, is exact up to the allocator's rounding: the
arguments (params, optimizer state, batch, and the cache in decode), the
outputs, and the aliases of what the reference donates (params and
optimizer state in train, the cache in decode) are sums of shard sizes;
``temp_size_in_bytes`` is the step's peak (``StepCost.peak_bytes``): the
most bytes the storages its ops allocated held at once, each storage
followed to its death (activations, gradients, collective buffers and
the new outputs).  PyTorch runs eagerly and donates nothing, so
``per_device_total`` (``per_device_hbm_gb``) is arguments + that peak,
what the step holds at its fullest, not the reference's arguments +
outputs + temporaries − aliases.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape train_4k \\
        --mesh single --elastic 4     # degraded mesh after losing 4 hosts

Results go to ``build/dryrun/`` (git-ignored), one JSON file a cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import (
    ACT_RULES,
    CACHE_RULES,
    PARAM_RULES,
    StepConfig,
    activation_sharding,
    build_prefill_step,
    build_serve_step,
    build_train_step,
    distribute_defs,
)
from repro_torch.distributed.sharding import ShardingRules, local_shape, placements_for, spec_for
from repro_torch.launch.env_flags import apply_env_flags
from repro_torch.launch.mesh import elastic_mesh_shape, make_elastic_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES, batch_axes, batch_specs, shape_applicable
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_defs, param_defs
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import opt_state_defs
from repro_torch.roofline import analyze, count_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: one H100's HBM, bytes (the datasheet's 80 GB)
HBM_BYTES = 80e9

# per-arch step tuning for the train_4k cell: microbatch count + dtypes,
# as the reference chose them for its per-device HBM budget
TRAIN_TUNING: dict[str, tuple[int, str, str]] = {
    # name: (microbatches, accum_dtype, moment_dtype)
    "deepseek-v3-671b": (8, "bfloat16", "bfloat16"),   # halves grad-AR
    "deepseek-67b": (16, "bfloat16", "bfloat16"),
    "llava-next-34b": (8, "bfloat16", "bfloat16"),
    "gemma3-27b": (8, "float32", "float32"),
    "recurrentgemma-9b": (4, "float32", "float32"),
    "minitron-4b": (4, "float32", "float32"),
    "granite-3-2b": (1, "float32", "float32"),   # mb=1 + full-DP
    "seamless-m4t-medium": (2, "float32", "float32"),
    "olmoe-1b-7b": (4, "float32", "float32"),
    "mamba2-780m": (2, "float32", "float32"),
}


def step_tuning(cfg: ModelConfig) -> tuple[StepConfig, OptConfig]:
    mb, acc, mom = TRAIN_TUNING.get(cfg.name, (1, "float32", "float32"))
    return (StepConfig(microbatches=mb, remat=True, accum_dtype=acc),
            OptConfig(moment_dtype=mom))


# per-arch activation-rule overrides.  For small dense models, TP
# all-reduces of activations dominate; sharding the batch over
# (data × model) turns the layout into pure DP/ZeRO-3 (weights all-gathered
# per layer — far fewer bytes than per-layer activation all-reduces when
# params << activations).
ARCH_ACT_OVERRIDES: dict[str, dict] = {
    "granite-3-2b": {"batch": (("pod", "data", "model"), ("pod", "data"),
                               ("data",))},
}


def act_rules_for(cfg: ModelConfig, shape_kind: str) -> ShardingRules:
    if shape_kind == "train" and cfg.name in ARCH_ACT_OVERRIDES:
        return ACT_RULES.replace(**ARCH_ACT_OVERRIDES[cfg.name])
    return ACT_RULES


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str
    seconds: float = 0.0
    error: str = ""
    memory: dict | None = None
    roofline: dict | None = None
    skip_reason: str = ""


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def _memory_dict(args: Any, outputs: Any, aliased: Any, peak: int) -> dict:
    d = {"argument_size_in_bytes": _local_bytes(args),
         "output_size_in_bytes": _local_bytes(outputs),
         "temp_size_in_bytes": peak,      # outputs included: see the module docstring
         "alias_size_in_bytes": _local_bytes(aliased)}
    d["per_device_total"] = d["argument_size_in_bytes"] + peak
    return d


def _distribute_batch(specs: dict, axes: dict, rules: ShardingRules, mesh: Any) -> dict:
    from torch.distributed.tensor import DTensor

    out = {}
    for k, t in specs.items():
        pl = placements_for(spec_for(tuple(t.shape), axes[k], rules, mesh), t.dim(), mesh)
        local = torch.empty(local_shape(tuple(t.shape), pl, mesh), dtype=t.dtype,
                            device="meta")
        out[k] = DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                    stride=t.stride())
    return out


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("run_cell starts its own fake process group; one is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             elastic_lost_hosts: int = 0, save: bool = True) -> CellResult:
    import torch.distributed as dist

    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    cell = CellResult(arch=cfg.name, shape=shape, mesh=mesh_kind, status="skip",
                      skip_reason=reason)
    if not ok:
        return cell

    multi = mesh_kind == "multi"
    if elastic_lost_hosts:
        cell.mesh = f"{mesh_kind}-elastic{elastic_lost_hosts}"
    chips = math.prod(elastic_mesh_shape(elastic_lost_hosts, multi_pod=multi)[0])
    sp = SHAPES[shape]
    step_cfg, opt_cfg = step_tuning(cfg)

    t0 = time.time()
    _fake_group(chips)
    try:
        mesh = (make_elastic_mesh(elastic_lost_hosts, multi_pod=multi, device_type="cpu")
                if elastic_lost_hosts else make_production_mesh(multi_pod=multi,
                                                                device_type="cpu"))
        pdefs = param_defs(cfg)
        params = distribute_defs(pdefs, PARAM_RULES, mesh)
        act_rules = act_rules_for(cfg, sp.kind)
        batch = _distribute_batch(batch_specs(cfg, shape), batch_axes(cfg, shape),
                                  act_rules, mesh)
        with activation_sharding(mesh, act_rules):
            if sp.kind == "train":
                opt_state = distribute_defs(opt_state_defs(pdefs, opt_cfg), PARAM_RULES, mesh)
                step = build_train_step(cfg, opt_cfg, step_cfg)
                args, aliased = (params, opt_state, batch), (params, opt_state)
                tokens = sp.global_batch * sp.seq_len
            elif sp.kind == "prefill":
                step = build_prefill_step(cfg)
                args, aliased = (params, batch), ()
                tokens = sp.global_batch * sp.seq_len
            else:  # decode
                cache = distribute_defs(cache_defs(cfg, sp.global_batch, sp.seq_len),
                                        CACHE_RULES, mesh)
                step = build_serve_step(cfg)
                args, aliased = (params, cache, batch), (cache,)
                tokens = sp.global_batch  # one token per sequence
            outputs, cost = count_step(step, *args)

        mem = _memory_dict(args, outputs, aliased, cost.peak_bytes)
        report = analyze(
            arch=cfg.name, shape=shape, mesh_name=cell.mesh, chips=chips, cost=cost,
            cfg=cfg, defs=pdefs, kind="train" if sp.kind == "train" else "serve",
            tokens=tokens, per_device_hbm_bytes=mem["per_device_total"])

        cell.status = "ok"
        cell.memory = mem
        cell.roofline = report.row()
        cell.roofline["fits_hbm"] = mem["per_device_total"] <= HBM_BYTES
        cell.roofline["coll_breakdown"] = dict(report.coll_breakdown)
        cell.roofline["coll_counts"] = dict(cost.coll_counts)
        cell.roofline["kernel_launches"] = dict(cost.kernel_launches)
        cell.roofline["xla_reported_flops"] = f"{report.xla_reported_flops:.3e}"
    except Exception as e:  # noqa: BLE001 - report a cell's failure as data
        cell.status = "fail"
        cell.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-2000:]}"
    finally:
        dist.destroy_process_group()
        cell.seconds = time.time() - t0
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{cfg.name}__{shape}__{cell.mesh}.json"
        out.write_text(json.dumps(dataclasses.asdict(cell), indent=1))
    return cell


def main() -> None:
    apply_env_flags("dryrun")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (dashed ok)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all archs × shapes")
    ap.add_argument("--elastic", type=int, default=0,
                    help="lost hosts for the degraded-mesh dry-run")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rows = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                cell = run_cell(arch, shape, mk,
                                elastic_lost_hosts=args.elastic,
                                save=not args.no_save)
                r = cell.roofline or {}
                print(f"{cell.arch:22s} {shape:12s} {cell.mesh:8s} "
                      f"{cell.status:5s} {cell.seconds:7.1f}s "
                      f"hbm/dev={r.get('per_device_hbm_gb', '-'):>8} "
                      f"dom={r.get('dominant', cell.skip_reason or cell.error[:60])}",
                      flush=True)
                rows.append(cell)
    n_ok = sum(1 for c in rows if c.status == "ok")
    n_skip = sum(1 for c in rows if c.status == "skip")
    n_fail = sum(1 for c in rows if c.status == "fail")
    print(f"\n{n_ok} ok, {n_skip} skipped (noted), {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
