"""llava-next-34b [vlm]: 60L d7168 56H (GQA kv=8) ff20480 v64000 — anyres
tiling [hf:llava-hf/llava-v1.6].  Backbone only: the vision frontend is a
stub; ``input_specs`` provides precomputed patch embeddings (B, S, d)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    pattern=(("attn", "dense"),),
    input_kind="embeds",
    head_pad=64,   # 56 heads don't divide the 16-way model axis (§Perf)
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, head_dim=16)
