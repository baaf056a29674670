"""Model zoo of the port: the dense GQA decoder (granite-3-2b) and the
Mamba-2 SSD model (mamba2-780m)."""
from repro_torch.models.config import (
    BlockKind,
    MLACfg,
    ModelConfig,
    MoECfg,
    RGLRUCfg,
    SSMCfg,
)
from repro_torch.models.model import (
    cache_defs,
    decode_step,
    forward_train,
    loss_fn,
    param_defs,
    prefill_forward,
)
from repro_torch.models.spec import (
    ParamDef,
    abstract,
    logical_axes,
    materialize,
    param_bytes,
    param_count,
)

__all__ = [
    "ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "RGLRUCfg", "BlockKind",
    "param_defs", "cache_defs", "forward_train", "loss_fn", "prefill_forward", "decode_step",
    "ParamDef", "abstract", "logical_axes", "materialize",
    "param_count", "param_bytes",
]
