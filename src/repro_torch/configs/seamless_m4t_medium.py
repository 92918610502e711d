"""seamless-m4t-medium — enc-dec, multimodal audio [arXiv:2308.11596; hf].

12L (encoder) + 12L (decoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (batch, source_len, d_model).  vocab 256206 not divisible by 16 =>
embedding shards on d_model.  Decode shapes exercise the decoder (self-attn KV
cache + static cross-attention KV over the encoded source).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    encoder=EncoderConfig(num_layers=12, source_len=160),
    rope_theta=10_000.0,
    act="gelu",
    supports_long_context=False,
    source="arXiv:2308.11596; hf",
)
