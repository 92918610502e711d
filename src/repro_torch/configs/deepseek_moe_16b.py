"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16, i.e. MHA) d_ff_expert=1408 vocab=102400,
2 shared + 64 routed experts top-6; layer 0 is dense with d_ff 10944.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_moe_layer=1,
        d_ff_dense=10944,
    ),
    rope_theta=10_000.0,
    act="silu",
    supports_long_context=False,
    source="arXiv:2401.06066; hf",
)
