"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) head_dim=64 d_ff=5504 vocab=32001, ssm_state=16.
Sliding window (1024) on all but 3 global layers (first/middle/last); 128 meta
tokens prepended.  25 heads and vocab 32001 are not divisible by 16 =>
attention head-sharding and vocab-sharding fall back per DESIGN.md §6.
Hybrid constant-state SSM path => long_500k runs.
The layer stack is irregular (3 global layers) => unrolled, not scanned.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_pattern="hybrid",
    window_size=1024,
    hybrid=HybridConfig(
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk_size=256),
        num_meta_tokens=128,
        global_layers=(0, 15, 31),
    ),
    rope_theta=10_000.0,
    act="silu",
    scan_layers=False,
    supports_long_context=True,
    source="arXiv:2411.13676; hf",
)
