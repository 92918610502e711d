"""gemma3-1b — dense, 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256 (decoupled).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attn_pattern="gemma3",
    window_size=1024,
    local_per_period=5,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    act="gelu",
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
