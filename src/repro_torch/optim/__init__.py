"""The port's optimizer: AdamW (``optim/adamw.py``).  The reference's
int8 error-feedback compressor (``src/repro/optim/compress.py``) is not
ported yet: ROADMAP.md, Queue 1 item 1."""
from repro_torch.optim.adamw import (
    OptConfig,
    adamw_apply,
    init_opt_state,
    lr_at,
    opt_state_defs,
)

__all__ = ["OptConfig", "adamw_apply", "opt_state_defs", "init_opt_state", "lr_at"]
