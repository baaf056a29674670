"""olmoe-1b-7b [moe]: 16L d2048 16H (GQA kv=16) v50304, 64 experts top-8
ff1024/expert [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    pattern=(("attn", "moe"),),
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0,
               capacity_factor=1.25, dispatch="shard_map"),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=256, head_dim=16,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=64, n_shared=0,
                   capacity_factor=1.25, dispatch="gshard"),
    )
