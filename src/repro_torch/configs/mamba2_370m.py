"""mamba2-370m — SSM, SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64 => d_inner=2048, 32 SSD heads.
Attention-free => constant per-token state; long_500k runs.
vocab 50280 is not divisible by 16 => embedding shards on d_model (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
    tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2405.21060; unverified",
)
