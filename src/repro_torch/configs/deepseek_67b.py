"""deepseek-67b [dense]: 95L d8192 64H (GQA kv=8) ff22016 v102400 —
llama-arch [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128,
    pattern=(("attn", "dense"),),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=160, vocab_size=256, head_dim=16)
