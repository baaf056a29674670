"""gemma3-27b [dense]: 62L d5376 32H (GQA kv=16) ff21504 v262144 — 5:1
local:global sliding-window attention, 128k context [hf:google/gemma-3]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    # 5 local (sliding-window 1024) : 1 global, repeating
    pattern=(("swa", "dense"),) * 5 + (("attn", "dense"),),
    window=1024,
    tie_embeddings=True,
    subquadratic=True,   # SWA layers dominate; global layers are decode-linear
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, head_dim=16, window=32)
