"""DeepSeek-V2-Lite — multi-head latent attention over deepseek-moe's MoE
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite config.json].

27L d_model=2048 16H, q one projection (q_lora_rank null) to 16 x (128 +
64), a K / V latent of 512 and a shared roped key of 64, v 128; layer 0
dense with d_ff 10944, then 64 routed experts (1408 wide) top-6 over a
softmax, weights not renormalised, 2 shared; vocab 102400, untied; rope
theta 10000 with YaRN (factor 40 over 4096 positions, beta 32 / 1, mscale
0.707 / 0.707), 163840 positions.  head_dim is the query / key width.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, YarnConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_moe_layer=1,
        d_ff_dense=10944,
        norm_topk_prob=False,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    rope_theta=10_000.0,
    rope_scaling=YarnConfig(
        factor=40.0,
        original_max_position_embeddings=4096,
        beta_fast=32.0,
        beta_slow=1.0,
        mscale=0.707,
        mscale_all_dim=0.707,
    ),
    act="silu",
    supports_long_context=False,
    source="arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite",
)
