"""seamless-m4t-medium [audio]: enc-dec 12L+12L d1024 16H (GQA kv=16)
ff4096 v256206 [arXiv:2308.11596].  Backbone only: the speech frontend is
a stub; ``input_specs`` provides precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    pattern=(("attn", "dense"),),
    encoder_layers=12,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16)
