"""The port's optimizer: AdamW (``optim/adamw.py``) and the int8
error-feedback gradient compressor (``optim/compress.py``)."""
from repro_torch.optim.adamw import (
    OptConfig,
    adamw_apply,
    init_opt_state,
    lr_at,
    opt_state_defs,
)
from repro_torch.optim.compress import (
    compress_int8,
    compress_tree,
    decompress_int8,
    decompress_tree,
)

__all__ = ["OptConfig", "adamw_apply", "opt_state_defs", "init_opt_state", "lr_at",
           "compress_int8", "decompress_int8", "compress_tree", "decompress_tree"]
