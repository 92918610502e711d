"""Shared neural-net layers of the dense decoder: norms, rotary embeddings,
gated MLPs and attention, as plain functions over tensors and parameter
dicts (the JAX package's ``repro.models.layers``, in PyTorch).

Attention comes in three forms:

* ``attention``         -- prefill, online softmax chunked over KV blocks in
                           plain PyTorch (the reference's non-kernel baseline,
                           ``attn_impl="chunked"``);
* ``attention_trainable(impl="flash")`` -- the hand-written CUDA kernel
                           (``kernels/flash_attention.py``);
* ``decode_attention``  -- one new token against a KV cache with a per-
                           sequence validity mask.

Sharding annotations (the reference's ``ann``) are the identity without a
mesh and are dropped; the tensor-parallel ``shard_map`` paths raise until
``distributed/`` is ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash

NEG_INF = _flash.NEG_INF
_NOT_PORTED_TP = ("tp_comm='manual_bf16' (shard_map tensor parallelism) is not ported: it "
                  "waits for distributed/ (ROADMAP.md, queue 1, item 12)")


# --------------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + weight`` gain, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# --------------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos, sin [..., head_dim // 2] (f32 tables)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation.  x [B, S, H, hd]; cos, sin [B, S, hd // 2]
    (broadcast over heads).  Promotes to the tables' type, casts back."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# --------------------------------------------------------------------------- mlp
def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return F.silu if name == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def gated_mlp(x: torch.Tensor, p: dict, act: str = "silu", tp_comm: str = "auto") -> torch.Tensor:
    """SwiGLU / GeGLU MLP.  p = {w1 [D, F], w3 [D, F], w2 [F, D]}."""
    if tp_comm == "manual_bf16":
        raise NotImplementedError(_NOT_PORTED_TP)
    h = _act(act)(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


def row_parallel_out(o_flat: torch.Tensor, wo: torch.Tensor, tp_comm: str = "auto") -> torch.Tensor:
    """Attention output projection [B, S, H * hd] @ [H * hd, D]."""
    if tp_comm == "manual_bf16":
        raise NotImplementedError(_NOT_PORTED_TP)
    return o_flat @ wo


# --------------------------------------------------------------------------- attention
def _pick_block(seq: int, target: int = 512) -> int:
    """Largest divisor of ``seq`` that is <= target."""
    best = 1
    for b in range(1, min(seq, target) + 1):
        if seq % b == 0:
            best = b
    return best


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, n_meta: int = 0, q_offset: int = 0,
              scale: Optional[float] = None, max_block: int = 512) -> torch.Tensor:
    """Chunked online-softmax attention (prefill), plain PyTorch.

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] with H % KV == 0 (GQA).  Returns
    [B, Sq, H, hd] in v's type.  ``q_offset`` is the absolute position of
    q[0] relative to k[0] (0 for self-attention)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    qg = q.reshape(B, Sq, KV, G, hd)

    # Small sequences: one dense block.
    if Sq * Skv <= 1024 * 1024:
        s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
        mask = _flash.mask_block(torch.arange(Sq, device=dev) + q_offset,
                                 torch.arange(Skv, device=dev), causal=causal, window=window,
                                 n_meta=n_meta)
        s = torch.where(mask, s, neg)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
        return o.reshape(B, Sq, H, hd)

    q_blk = _pick_block(Sq, max_block)
    kv_blk = _pick_block(Skv, max_block)
    n_q = Sq // q_blk
    outs = []
    for qi in range(n_q):
        qb = qg[:, qi * q_blk:(qi + 1) * q_blk].float()
        q_pos = qi * q_blk + torch.arange(q_blk, device=dev) + q_offset
        q_end = (qi + 1) * q_blk - 1 + q_offset
        q_start = qi * q_blk + q_offset
        # block skipping: causal upper bound and window lower bound
        kv_hi = min((q_end // kv_blk) + 1, Skv // kv_blk) if causal else Skv // kv_blk
        kv_lo = max(0, (q_start - window + 1) // kv_blk) if window > 0 else 0
        n_meta_blocks = (n_meta + kv_blk - 1) // kv_blk if n_meta > 0 else 0
        idxs = list(range(min(n_meta_blocks, kv_lo))) + list(range(kv_lo, kv_hi))
        m = torch.full((B, KV, G, q_blk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_blk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_blk, hd), dtype=torch.float32, device=dev)
        for kv_i in idxs:
            k_b = k[:, kv_i * kv_blk:(kv_i + 1) * kv_blk]
            v_b = v[:, kv_i * kv_blk:(kv_i + 1) * kv_blk]
            k_pos = kv_i * kv_blk + torch.arange(kv_blk, device=dev)
            # bf16 operands, f32 products and sums (the reference's
            # preferred_element_type=f32)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, k_b.float()) * scale
            mask = _flash.mask_block(q_pos, k_pos, causal=causal, window=window, n_meta=n_meta)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v_b.float())
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_blk, H, hd).to(v.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid_mask: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a cache.

    q [B, H, hd]; k_cache, v_cache [B, S, KV, hd]; valid_mask [B, S] bool."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * scale
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(v_cache.dtype)


# --------------------------------------------------------------------------- flash wrapper
def _flash_call(q, k, v, causal, window, n_meta):
    """The flash kernel (CUDA tensors) or its plain version (CPU tensors).
    The reference's mesh branch (shard_map over the local batch x head
    shard) needs a mesh, which the port cannot build until distributed/ is
    ported (``DecoderModel(mesh=...)`` raises)."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window, n_meta=n_meta)


def attention_trainable(q, k, v, *, causal: bool = True, window: int = 0, n_meta: int = 0,
                        q_offset: int = 0, impl: str = "chunked"):
    """Attention with a selectable implementation: "chunked" (plain PyTorch,
    the baseline) or "flash" (the CUDA kernel, forward only: the reference's
    custom VJP waits for the training slice)."""
    if impl == "flash":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "attn_impl='flash' has no backward yet: it waits for the training slice "
                "(ROADMAP.md, queue 1, training)")
        return _flash_call(q, k, v, causal, window, n_meta)
    return attention(q, k, v, causal=causal, window=window, n_meta=n_meta, q_offset=q_offset)


# --------------------------------------------------------------------------- qkv projection helpers
def project_qkv(x: torch.Tensor, p: dict, cfg):
    """x [B, S, D] -> q [B, S, H, hd], k, v [B, S, KV, hd].  (The reference's
    optional qk-norm belongs to gemma3, which is not ported yet.)"""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def unembed(x: torch.Tensor, table: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Logits head in f32.  table is [V, D] if transpose (tied) else [D, V]."""
    w = table.T if transpose else table
    return (x @ w.to(x.dtype)).float()
