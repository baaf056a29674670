"""deepseek-v3-671b [moe]: 61L d7168 128H MLA, ff2048/expert, v129280,
MoE 1 shared + 256 routed top-8, first 3 layers dense (ff 18432), MTP
[arXiv:2412.19437]."""
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,            # dense layers (first 3) use the big FFN
    vocab_size=129280,
    pattern=(("mla", "moe"),),
    first_k_dense=3,
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
               capacity_factor=1.25, dispatch="shard_map"),
    mtp=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, first_k_dense=1,
        mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                   capacity_factor=1.25, dispatch="gshard"),
    )
