"""gemma3-4b — dense, 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-4b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256 (decoupled),
sliding window 1024, global layers every 6th, tied embeddings, qk-norm.
Sliding window on 5/6 layers bounds per-token state => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
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
    source="hf:google/gemma-3-4b-pt; unverified",
)
