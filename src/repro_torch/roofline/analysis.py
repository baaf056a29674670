"""Three-term roofline analysis of one counted step (the port of
``repro.roofline.analysis``).

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

on one H100's constants (``launch/mesh.py``: 989 TFLOP/s bf16, 3.35 TB/s
HBM, NVLink 4 at 450 GB/s a direction).  FLOPs, bytes and collective
bytes come from the eager counter (:func:`repro_torch.roofline.cost.count_step`),
which credits the Hopper kernels per launch; the reference took them from
a compiled XLA executable and its HLO text.  So the reference's
``collective_bytes(hlo_text)`` and ``hlo_cost(compiled)``, which parse
XLA artifacts, have no counterpart here.  :class:`RooflineReport` keeps
the reference's field names (``hlo_flops``, ``hlo_bytes``, ...): in the
port they hold the counter's numbers, and ``xla_reported_*`` what
dispatch saw without the kernels' credits.

``model_flops`` computes the useful-compute yardstick 6·N·D (train,
dense) or 6·N_active·D (MoE); the ratio MODEL_FLOPS / FLOPs exposes
remat and dispatch waste.  :func:`mfu` reads it against a measured time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW_PER_DIRECTION, PEAK_FLOPS_BF16
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import is_def, tree_leaves
from repro_torch.roofline.cost import StepCost


def active_param_count(cfg: ModelConfig, defs: Any) -> tuple[int, int]:
    """(total_params, active_params): routed experts count as top_k/E."""
    total = 0
    active = 0.0
    for d in tree_leaves(defs, is_def):
        n = math.prod(d.shape) if d.shape else 1
        total += n
        if cfg.moe and "experts" in d.axes:
            active += n * (cfg.moe.top_k / cfg.moe.n_experts)
        else:
            active += n
    return total, int(active)


def model_flops(cfg: ModelConfig, defs: Any, *, kind: str, tokens: int) -> float:
    """6·N_active·D for training, 2·N_active·D for inference."""
    _, active = active_param_count(cfg, defs)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


def mfu(model_flops: float, seconds: float, chips: int = 1) -> float:
    """Model FLOPs utilisation: the useful FLOPs over what ``chips`` cards
    at their bf16 peak could do in the measured ``seconds``."""
    return model_flops / (chips * PEAK_FLOPS_BF16 * seconds) if seconds > 0 else 0.0


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict[str, int]
    model_flops: float
    per_device_hbm_bytes: float = 0.0
    # every op's input and output bytes (eager, fusion-naive); the memory
    # term reads hlo_bytes, which is the same number in the port
    hlo_bytes_raw: float = 0.0
    # score bytes of attention products that reached HBM (the CPU's
    # blockwise mirror; a flash kernel keeps them on chip, and
    # memory_kernel_s subtracts them)
    attn_score_bytes: float = 0.0
    xla_reported_flops: float = 0.0   # dispatch alone, without the kernels' credits
    xla_reported_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def memory_kernel_s(self) -> float:
        """Memory term with the flash-attention kernel deployed (score
        tiles stay on chip; conservative — softmax reduce traffic on the
        tiles is still counted)."""
        return max(self.hlo_bytes - self.attn_score_bytes, 0.0) / (
            self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW_PER_DIRECTION)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful compute / achievable time: MODEL_FLOPS / (chips·peak·T_bound)
        where T_bound = max of the three terms (the bound on step time)."""
        t = max(self.compute_s, self.memory_s, self.collective_s)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16 * t)

    @property
    def roofline_fraction_kernel(self) -> float:
        """Roofline fraction with the flash kernel's on-chip score tiles
        subtracted from the memory term."""
        t = max(self.compute_s, self.memory_kernel_s, self.collective_s)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16 * t)

    def row(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": f"{self.hlo_flops:.3e}",
            "hlo_bytes": f"{self.hlo_bytes:.3e}",
            "hlo_bytes_raw": f"{self.hlo_bytes_raw:.3e}",
            "coll_bytes": f"{self.coll_bytes:.3e}",
            "compute_s": round(self.compute_s, 6),
            "memory_s": round(self.memory_s, 6),
            "memory_kernel_s": round(self.memory_kernel_s, 6),
            "collective_s": round(self.collective_s, 6),
            "dominant": self.dominant,
            "model_flops": f"{self.model_flops:.3e}",
            "useful_ratio": round(self.useful_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
            "roofline_fraction_kernel": round(self.roofline_fraction_kernel, 4),
            "per_device_hbm_gb": round(self.per_device_hbm_bytes / 2**30, 3),
        }


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, cost: StepCost,
            cfg: ModelConfig, defs: Any, kind: str, tokens: int,
            per_device_hbm_bytes: float = 0.0) -> RooflineReport:
    """All reported quantities are GLOBAL (one device's counted step ×
    chips), as in the reference."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops * chips, hlo_bytes=cost.bytes * chips,
        attn_score_bytes=cost.attn_score_bytes * chips,
        hlo_bytes_raw=cost.bytes * chips,
        coll_bytes=cost.coll_total * chips,
        coll_breakdown={k: int(v * chips) for k, v in cost.coll.items()},
        model_flops=model_flops(cfg, defs, kind=kind, tokens=tokens),
        per_device_hbm_bytes=per_device_hbm_bytes,
        xla_reported_flops=cost.aten_flops * chips,
        xla_reported_bytes=cost.aten_bytes * chips,
    )
