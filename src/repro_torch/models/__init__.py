"""Model zoo of the port: dense GQA decoders (granite-3-2b, minitron-4b),
sliding-window hybrids (gemma3-27b; recurrentgemma-9b with the RG-LRU),
the Mamba-2 SSD model (mamba2-780m), MoE (olmoe-1b-7b) and the
encoder-decoder backbone (seamless-m4t-medium)."""
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
