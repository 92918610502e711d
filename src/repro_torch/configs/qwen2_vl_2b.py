"""qwen2-vl-2b — VLM backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, head_dim=128,
mrope sections (16, 24, 24).  The vision frontend is a STUB: input_specs()
provides precomputed patch embeddings + 3D (t,h,w) positions.
12 heads not divisible by 16 => attention head-sharding falls back.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    vlm=VLMConfig(num_patches=256, mrope_sections=(16, 24, 24)),
    rope_theta=1_000_000.0,
    act="silu",
    supports_long_context=False,
    source="arXiv:2409.12191; hf",
)
