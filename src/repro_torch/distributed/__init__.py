"""Distribution plane of the port: the logical-axis sharding rules as
DTensor placements (``distributed/sharding.py``) and the step builders
(``distributed/step.py``)."""
from repro_torch.distributed.sharding import (
    ACT_RULES,
    CACHE_RULES,
    PARAM_RULES,
    PartitionSpec,
    ShardingRules,
    activation_sharding,
    defs_placements,
    defs_pspecs,
    distribute_defs,
    distribute_params,
    placements_for,
    spec_for,
)
from repro_torch.distributed.step import (
    StepConfig,
    build_prefill_step,
    build_serve_step,
    build_train_step,
)

__all__ = [
    "ShardingRules", "PARAM_RULES", "ACT_RULES", "CACHE_RULES", "PartitionSpec",
    "spec_for", "placements_for", "defs_pspecs", "defs_placements", "distribute_defs",
    "distribute_params", "activation_sharding",
    "StepConfig", "build_train_step", "build_serve_step", "build_prefill_step",
]
