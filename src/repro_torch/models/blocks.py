"""Transformer block definitions (the dense family).

Each block is a pair of plain functions:

* ``init_*_layer(gen, cfg, ...) -> params``  (one layer; ``n`` stacks them)
* ``apply_*(x, p, ctx, mode, cache) -> (x, aux, new_cache)``

``mode`` is "train", "prefill" or "decode".  Caches are dicts of tensors;
"train" writes none, "prefill" writes a fresh cache and "decode" updates
one token IN PLACE (the reference returns new arrays; its server
donates the old ones, so nothing reads them again).  The MoE, SSM and hybrid
blocks are not here yet; the local-window ring cache (gemma3, hymba) raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def not_ported(what: str) -> NotImplementedError:
    """``what`` is not ported yet; ROADMAP.md's queue 1 lists it."""
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1)")


def _check_global(layer_type: str, ctx: "Ctx") -> None:
    if layer_type == "local" and ctx.window > 0:
        raise not_ported("the local-window ring cache (gemma3, hymba)")


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""

    cfg: ModelConfig
    mesh: Any = None
    # rope tables: [B, S, hd//2] (prefill) or [B, 1, hd//2] (decode)
    cos_local: Any = None
    sin_local: Any = None
    cos_global: Any = None
    sin_global: Any = None
    lengths: Any = None  # [B] int32, tokens already in cache (decode)
    n_meta: int = 0
    moe_dispatch: str = "dense"
    max_cache_len: int = 0
    window: int = 0
    remat: bool = True
    causal: bool = True  # False for encoder stacks
    attn_impl: str = "chunked"  # "chunked" (plain PyTorch) | "flash" (CUDA kernel)
    tp_comm: str = "auto"

    def rope(self, layer_type: str):
        if layer_type == "global" and self.cos_global is not None:
            return self.cos_global, self.sin_global
        return self.cos_local, self.sin_local


# --------------------------------------------------------------------------- init helpers
def _dense(gen: torch.Generator, shape, dtype, n: Optional[int] = None, scale=None):
    """Normal weights scaled by fan_in ** -0.5, made on the generator's
    device; ``n`` stacks n layers' worth in one draw."""
    scale = scale if scale is not None else shape[0] ** -0.5
    full = tuple(shape) if n is None else (n, *shape)
    return (torch.randn(full, generator=gen, device=gen.device) * scale).to(dtype)


def _zeros(shape, dtype, n: Optional[int], device):
    return torch.zeros(tuple(shape) if n is None else (n, *shape), dtype=dtype, device=device)


def init_attn_params(gen, cfg: ModelConfig, dtype, n: Optional[int] = None) -> dict:
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": _dense(gen, (D, H * hd), dtype, n),
        "wk": _dense(gen, (D, KV * hd), dtype, n),
        "wv": _dense(gen, (D, KV * hd), dtype, n),
        "wo": _dense(gen, (H * hd, D), dtype, n),
    }


def init_mlp_params(gen, d_model: int, d_ff: int, dtype, n: Optional[int] = None) -> dict:
    return {
        "w1": _dense(gen, (d_model, d_ff), dtype, n),
        "w3": _dense(gen, (d_model, d_ff), dtype, n),
        "w2": _dense(gen, (d_ff, d_model), dtype, n),
    }


# --------------------------------------------------------------------------- attention sub-block
def _init_attn_cache(cfg: ModelConfig, B: int, layer_type: str, ctx: Ctx, dtype,
                     device) -> dict:
    _check_global(layer_type, ctx)
    shape = (B, ctx.max_cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_sub(x: torch.Tensor, p: dict, ctx: Ctx, layer_type: str, mode: str,
             cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-block (no residual / norm).  x [B, S, D] or [B, 1, D]."""
    _check_global(layer_type, ctx)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    cfg = ctx.cfg
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = L.project_qkv(x, p, cfg)
    cos, sin = ctx.rope(layer_type)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    if mode in ("train", "prefill"):
        o = L.attention_trainable(q, k, v, causal=ctx.causal, n_meta=ctx.n_meta,
                                  impl=ctx.attn_impl)
        new_cache = None
        if mode == "prefill":
            new_cache = _write_prefill_cache(cfg, ctx, layer_type, k, v)
    else:  # decode: S == 1
        new_cache, k_all, v_all, valid = _decode_cache_update(cfg, ctx, layer_type, cache,
                                                              k[:, 0], v[:, 0])
        o = L.decode_attention(q[:, 0], k_all, v_all, valid)[:, None]
    out = L.row_parallel_out(o.reshape(B, S, H * hd), p["wo"], ctx.tp_comm)
    return out, new_cache


def _write_prefill_cache(cfg: ModelConfig, ctx: Ctx, layer_type: str, k, v) -> dict:
    B, S = k.shape[0], k.shape[1]
    ck = torch.zeros((B, ctx.max_cache_len, k.shape[2], k.shape[3]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    ck[:, :S] = k
    cv[:, :S] = v
    return {"k": ck, "v": cv}


def _decode_cache_update(cfg, ctx: Ctx, layer_type: str, cache: dict, k1, v1):
    """k1, v1 [B, KV, hd] for the current token at position ctx.lengths.

    Writes in place.  A position past the cache's end (an idle slot keeps
    counting up) is dropped, as JAX drops an out-of-range ``.at[].set``: the
    row is rewritten with what it holds, with no host sync and no
    out-of-range index on the card."""
    ck, cv = cache["k"], cache["v"]
    B, Sc = ck.shape[0], ck.shape[1]
    bidx = torch.arange(B, device=ck.device)
    pos = ctx.lengths.long()
    inside = (pos < Sc)[:, None, None]
    at = pos.clamp(0, Sc - 1)
    ck[bidx, at] = torch.where(inside, k1.to(ck.dtype), ck[bidx, at])
    cv[bidx, at] = torch.where(inside, v1.to(cv.dtype), cv[bidx, at])
    valid = torch.arange(Sc, device=ck.device)[None] <= pos[:, None]
    return {"k": ck, "v": cv}, ck, cv, valid


# --------------------------------------------------------------------------- full blocks
def init_dense_layer(gen, cfg: ModelConfig, dtype, d_ff: Optional[int] = None,
                     n: Optional[int] = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": _zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": init_attn_params(gen, cfg, dtype, n),
        "mlp": init_mlp_params(gen, cfg.d_model, d_ff or cfg.d_ff, dtype, n),
    }


def apply_dense(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    h, new_cache = attn_sub(L.rms_norm(x, p["ln1"], ctx.cfg.norm_eps), p["attn"], ctx,
                            layer_type, mode, cache)
    x = x + h
    x = x + L.gated_mlp(L.rms_norm(x, p["ln2"], ctx.cfg.norm_eps), p["mlp"], ctx.cfg.act,
                        tp_comm=ctx.tp_comm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


def init_block_cache(cfg: ModelConfig, B: int, layer_type: str, ctx: Ctx, dtype,
                     device) -> dict:
    """Cache structure for one layer (matches what prefill / decode produce)."""
    if cfg.family in ("ssm", "hybrid"):
        raise not_ported(f"the {cfg.family} cache")
    return _init_attn_cache(cfg, B, layer_type, ctx, dtype, device)
