"""Roofline plane of the port: FLOPs, bytes and collectives of one eager
step against the H100's peaks (the port of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (
    RooflineReport,
    active_param_count,
    analyze,
    mfu,
    model_flops,
)
from repro_torch.roofline.cost import StepCost, count_step, counting

__all__ = ["RooflineReport", "StepCost", "active_param_count", "analyze", "count_step",
           "counting", "mfu", "model_flops"]
