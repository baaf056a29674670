"""granite-3-2b [dense]: 40L d2048 32H (GQA kv=8) ff8192 v49155 — GQA
[hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155, head_dim=64,
    pattern=(("attn", "dense"),),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, head_dim=16)
