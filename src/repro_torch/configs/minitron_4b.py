"""minitron-4b [dense]: 32L d3072 24H (GQA kv=8) ff9216 v256000 — pruned
nemotron [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
    pattern=(("attn", "dense"),),
    head_pad=32,   # 24 heads don't divide the 16-way model axis (§Perf)
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
                         d_ff=96, vocab_size=256, head_dim=16)
