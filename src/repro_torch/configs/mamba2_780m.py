"""mamba2-780m [ssm]: 48L d1536 attn-free, SSD state 128 (state-space
duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=48, n_kv_heads=48,   # heads = d_inner/64
    d_ff=0, vocab_size=50280, head_dim=64,
    pattern=(("ssd", "none"),),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=128, conv_width=4,
               n_groups=1),
    tie_embeddings=True,
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                         vocab_size=256,
                         ssm=SSMCfg(d_state=16, head_dim=16, expand=2,
                                    chunk=32, conv_width=4, n_groups=1))
