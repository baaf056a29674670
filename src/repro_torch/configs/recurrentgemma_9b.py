"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 v256000 —
RG-LRU + local attention, 2 recurrent : 1 local-attn [arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig, RGLRUCfg

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    pattern=(("rglru", "dense"), ("rglru", "dense"), ("swa", "dense")),
    window=2048,
    rglru=RGLRUCfg(conv_width=4, lru_width=0),
    tie_embeddings=True,
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
                         d_ff=128, vocab_size=256, head_dim=16, window=32,
                         rglru=RGLRUCfg(conv_width=4, lru_width=64))
