"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (expert) vocab=202048,
MoE 128 routed experts top-1 + 1 shared expert.  Maverick INTERLEAVES
dense/MoE layers (interleave_moe_layer_step=2): with every layer MoE the
param count would be ~780B, contradicting the 400B-A17B name; with 24 MoE
layers it lands at ~400B total / ~17B active (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        first_moe_layer=1,
        moe_every=2,
        d_ff_dense=8192,
    ),
    rope_theta=500_000.0,
    act="silu",
    supports_long_context=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
