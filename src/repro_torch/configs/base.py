"""Config dataclasses for the model zoo.

Every assigned architecture is described by a frozen ``ModelConfig``.  Configs are
plain data — they never touch device state, so importing them is always safe.

``reduced()`` returns a small same-family config for CPU smoke tests; a full
config runs on the card (``chip_smoke.py`` serves tinyllama-1.1b at full
width and depth).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (per-layer)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # Index of the first MoE layer; layers before it use a dense MLP
    # (deepseek-moe keeps layer 0 dense).
    first_moe_layer: int = 0
    # MoE every k-th layer from first_moe_layer (llama4-maverick interleaves
    # dense/MoE with step 2); 1 = every layer.
    moe_every: int = 1
    # Dense d_ff used by the non-MoE leading layers (if any).
    d_ff_dense: int = 0
    # Router options.
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001
    # whether the top-k weights are renormalised to sum to 1 (deepseek-moe
    # does; DeepSeek-V2's ``norm_topk_prob`` false keeps the softmax's)
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) models.  The modality frontend is a
    STUB: inputs are precomputed frame embeddings of shape
    (batch, source_len, frontend_dim)."""

    num_layers: int
    source_len: int = 160
    frontend_dim: int = 0  # 0 -> same as d_model


@dataclass(frozen=True)
class VLMConfig:
    """VLM stub frontend: precomputed patch embeddings + M-RoPE sections."""

    num_patches: int = 256
    patch_dim: int = 0  # 0 -> same as d_model
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of head_dim/2


@dataclass(frozen=True)
class HybridConfig:
    """Hymba-style parallel attention + SSM heads inside one layer."""

    ssm: SSMConfig = field(default_factory=SSMConfig)
    num_meta_tokens: int = 128
    # Layer indices that use global (full) attention; the rest use the sliding
    # window.  Hymba uses first / middle / last.
    global_layers: Tuple[int, ...] = ()


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434): keys and
    values come from one latent of ``kv_lora_rank`` per token (the cache),
    queries from x by one projection (DeepSeek-V2-Lite's: no q latent);
    each head's query and key are ``qk_nope_head_dim`` plain dims and
    ``qk_rope_head_dim`` roped dims, the rope part of the key one head
    shared by all."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A cached token's width: the latent and the shared roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class YarnConfig:
    """YaRN rope scaling (arXiv:2309.00071, as DeepSeek-V2 configures it):
    frequencies between the original and the ``factor``-interpolated ones
    over a ramp of rotations ``beta_fast`` .. ``beta_slow`` within
    ``original_max_position_embeddings``; cos and sin times
    ``m(mscale) / m(mscale_all_dim)`` and the softmax scale times
    ``m(mscale_all_dim) ** 2``, where ``m(a) = 0.1 a ln(factor) + 1``."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- attention structure --------------------------------------------------
    # "global" for full causal attention everywhere; "gemma3" for the repeating
    # (5 local : 1 global) period; "hybrid" per HybridConfig.global_layers.
    attn_pattern: str = "global"
    window_size: int = 0  # sliding window for local layers
    local_per_period: int = 5  # gemma3: locals per period (period = locals + 1)
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 uses a different theta for globals
    logit_softcap: float = 0.0
    qk_norm: bool = False

    # -- optional blocks -------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm: Optional[VLMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # latent attention in place of the heads' own K / V (head_dim is then
    # the query / key width, nope + rope), and its rope scaling
    mla: Optional[MLAConfig] = None
    rope_scaling: Optional[YarnConfig] = None

    # -- misc ------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"  # silu | gelu
    dtype: str = "bfloat16"
    # layers are scanned unless the stack is irregular (hymba)
    scan_layers: bool = True
    # whether long_500k applies (sub-quadratic state); pure full-attention
    # archs skip it (recorded as SKIP in the dry-run table).
    supports_long_context: bool = False
    # arbitrary provenance note
    source: str = ""

    # ---------------------------------------------------------------------
    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer attention type ('global' | 'local')."""
        if self.attn_pattern == "global":
            return ("global",) * self.num_layers
        if self.attn_pattern == "gemma3":
            period = self.local_per_period + 1
            out = []
            for i in range(self.num_layers):
                out.append("global" if (i % period) == self.local_per_period else "local")
            return tuple(out)
        if self.attn_pattern == "hybrid":
            assert self.hybrid is not None
            g = set(self.hybrid.global_layers)
            return tuple("global" if i in g else "local" for i in range(self.num_layers))
        raise ValueError(f"unknown attn_pattern {self.attn_pattern}")

    def attn_params(self) -> int:
        """One layer's attention projections."""
        d, H = self.d_model, self.num_heads
        if self.mla is not None:
            m = self.mla
            return (d * H * m.qk_head_dim + d * m.latent_dim
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                    + H * m.v_head_dim * d)
        h = H * self.head_dim
        kvh = self.num_kv_heads * self.head_dim
        return d * h + 2 * d * kvh + h * d

    def num_params(self) -> int:
        """Approximate parameter count (embedding + layers), for 6ND math."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = self.attn_params()
        mlp = 3 * d * f
        per_layer = attn + mlp
        if self.moe is not None:
            e = self.moe
            moe_layers = len(self.moe_layer_indices())
            dense_layers = L - moe_layers
            moe_mlp = 3 * d * e.d_ff_expert * (e.num_experts + e.num_shared_experts)
            dense_mlp = 3 * d * (e.d_ff_dense or f)
            per = attn
            total = emb + moe_layers * (per + moe_mlp) + dense_layers * (per + dense_mlp)
            return total
        if self.family == "ssm":
            assert self.ssm is not None
            di = self.ssm.d_inner(d)
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state) + di * d
            return emb + L * per_layer
        if self.hybrid is not None:
            di = self.hybrid.ssm.d_inner(d)
            ssm_per = d * di + di * d
            per_layer = attn + mlp + ssm_per
        total = emb + L * per_layer
        if self.encoder is not None:
            # encoder layers: self-attn + mlp; decoder additionally cross-attn
            enc = self.encoder.num_layers * (attn + mlp)
            total += enc + L * attn  # cross-attention blocks in decoder
        return total

    def moe_layer_indices(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        e = self.moe
        return tuple(
            i for i in range(e.first_moe_layer, self.num_layers)
            if (i - e.first_moe_layer) % e.moe_every == 0
        )

    def active_params(self) -> int:
        """Active (per-token) parameter count — differs for MoE."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        d, L = self.d_model, self.num_layers
        attn = self.attn_params()
        act_mlp = 3 * d * e.d_ff_expert * (e.top_k + e.num_shared_experts)
        dense_mlp = 3 * d * (e.d_ff_dense or self.d_ff)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n_moe = len(self.moe_layer_indices())
        return emb + (L - n_moe) * (attn + dense_mlp) + n_moe * (attn + act_mlp)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window_size=min(self.window_size, 16) if self.window_size else 0,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_dense=128 if self.moe.d_ff_dense else 0,
                first_moe_layer=min(self.moe.first_moe_layer, 1),
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32
            )
        if self.encoder is not None:
            changes["encoder"] = dataclasses.replace(
                self.encoder, num_layers=2, source_len=24
            )
        if self.vlm is not None:
            changes["vlm"] = dataclasses.replace(
                self.vlm, num_patches=8, mrope_sections=(4, 6, 6)
            )
        if self.hybrid is not None:
            changes["hybrid"] = dataclasses.replace(
                self.hybrid,
                ssm=dataclasses.replace(self.hybrid.ssm, d_state=8, head_dim=16, chunk_size=16),
                num_meta_tokens=4,
                global_layers=(0, 2),
            )
        if self.mla is not None:
            changes["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                v_head_dim=16)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
