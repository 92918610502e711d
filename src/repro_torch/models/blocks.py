"""Block definitions: dense (with gemma3's local windows), MoE and Mamba-2.

Each block is a pair of plain functions:

* ``init_*_layer(gen, cfg, ...) -> params``  (one layer; ``n`` stacks them)
* ``apply_*(x, p, ctx, mode, cache) -> (x, aux, new_cache)``

``mode`` is "train", "prefill" or "decode".  Caches are dicts of tensors;
"train" writes none, "prefill" writes a fresh cache and "decode" updates
one token IN PLACE (the reference returns new arrays; its server
donates the old ones, so nothing reads them again).  A "local" layer with a
window keeps a ring cache of ``n_meta + window`` slots with each slot's
absolute position (-1: empty).  An SSM layer's cache is its f32 SSD state
and its convolution window.  The hybrid block is not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib


def not_ported(what: str) -> NotImplementedError:
    """``what`` is not ported yet; ROADMAP.md's queue 1 lists it."""
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1)")


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
#: leading stack dims of a parameter: None (one layer), n layers, or a
#: tuple such as (periods, locals a period)
Stack = Optional[Union[int, Tuple[int, ...]]]


def _full(shape, n: Stack) -> tuple:
    lead = () if n is None else (n,) if isinstance(n, int) else tuple(n)
    return lead + tuple(shape)


def _dense(gen: torch.Generator, shape, dtype, n: Stack = None, scale=None):
    """Normal weights scaled by fan_in ** -0.5, made on the generator's
    device; ``n`` stacks that many layers' worth in one draw."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return (torch.randn(_full(shape, n), generator=gen, device=gen.device) * scale).to(dtype)


def _zeros(shape, dtype, n: Stack, device):
    return torch.zeros(_full(shape, n), dtype=dtype, device=device)


def init_attn_params(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": _dense(gen, (D, H * hd), dtype, n),
        "wk": _dense(gen, (D, KV * hd), dtype, n),
        "wv": _dense(gen, (D, KV * hd), dtype, n),
        "wo": _dense(gen, (H * hd, D), dtype, n),
    }
    if cfg.qk_norm:
        p["q_norm"] = _zeros((hd,), dtype, n, gen.device)
        p["k_norm"] = _zeros((hd,), dtype, n, gen.device)
    return p


def init_mlp_params(gen, d_model: int, d_ff: int, dtype, n: Stack = None) -> dict:
    return {
        "w1": _dense(gen, (d_model, d_ff), dtype, n),
        "w3": _dense(gen, (d_model, d_ff), dtype, n),
        "w2": _dense(gen, (d_ff, d_model), dtype, n),
    }


# --------------------------------------------------------------------------- attention sub-block
def _is_ring(layer_type: str, ctx: Ctx) -> bool:
    return layer_type == "local" and ctx.window > 0


def _init_attn_cache(cfg: ModelConfig, B: int, layer_type: str, ctx: Ctx, dtype,
                     device) -> dict:
    Sc = ctx.n_meta + ctx.window if _is_ring(layer_type, ctx) else ctx.max_cache_len
    shape = (B, Sc, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if _is_ring(layer_type, ctx):
        cache["pos"] = torch.full((B, Sc), -1, dtype=torch.int32, device=device)
    return cache


def attn_sub(x: torch.Tensor, p: dict, ctx: Ctx, layer_type: str, mode: str,
             cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-block (no residual / norm).  x [B, S, D] or [B, 1, D]."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    cfg = ctx.cfg
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    qk_p = {"q_norm": p["q_norm"], "k_norm": p["k_norm"]} if cfg.qk_norm else None
    q, k, v = L.project_qkv(x, p, cfg, qk_norm_p=qk_p)
    cos, sin = ctx.rope(layer_type)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    window = ctx.window if layer_type == "local" else 0

    if mode in ("train", "prefill"):
        o = L.attention_trainable(q, k, v, causal=ctx.causal, window=window,
                                  n_meta=ctx.n_meta, impl=ctx.attn_impl)
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
    cache = _init_attn_cache(cfg, B, layer_type, ctx, k.dtype, k.device)
    ck, cv = cache["k"], cache["v"]
    if not _is_ring(layer_type, ctx):
        ck[:, :S] = k
        cv[:, :S] = v
        return cache
    n_meta, W = ctx.n_meta, ctx.window
    cpos = cache["pos"]
    if n_meta > 0:
        ck[:, :n_meta] = k[:, :n_meta]
        cv[:, :n_meta] = v[:, :n_meta]
        cpos[:, :n_meta] = torch.arange(n_meta, dtype=torch.int32, device=k.device)
    # the last `take` body tokens, each at slot n_meta + (pos - n_meta) % W
    take = min(W, S - n_meta)
    pos = torch.arange(S - take, S, device=k.device)
    slots = n_meta + (pos - n_meta) % W
    ck[:, slots] = k[:, S - take:]
    cv[:, slots] = v[:, S - take:]
    cpos[:, slots] = pos.to(torch.int32)
    return cache


def _decode_cache_update(cfg, ctx: Ctx, layer_type: str, cache: dict, k1, v1):
    """k1, v1 [B, KV, hd] for the current token at position ctx.lengths.

    Writes in place.  A ring cache writes slot n_meta + (pos - n_meta) % W
    (a meta position its own slot) and attends to the slots whose position
    is within the window, or a meta token.  In a full cache a position past
    the end (an idle slot keeps counting up) is dropped, as JAX drops an
    out-of-range ``.at[].set``: the row is rewritten with what it holds,
    with no host sync and no out-of-range index on the card."""
    ck, cv = cache["k"], cache["v"]
    B, Sc = ck.shape[0], ck.shape[1]
    bidx = torch.arange(B, device=ck.device)
    pos = ctx.lengths.long()
    if _is_ring(layer_type, ctx):
        n_meta, W = ctx.n_meta, ctx.window
        slot = torch.where(pos < n_meta, pos, n_meta + (pos - n_meta) % W)
        cpos = cache["pos"]
        ck[bidx, slot] = k1.to(ck.dtype)
        cv[bidx, slot] = v1.to(cv.dtype)
        cpos[bidx, slot] = pos.to(cpos.dtype)
        in_window = (pos[:, None] - cpos) < W
        is_meta = (cpos >= 0) & (cpos < n_meta)
        valid = (cpos >= 0) & (cpos <= pos[:, None]) & (in_window | is_meta)
        return {"k": ck, "v": cv, "pos": cpos}, ck, cv, valid
    inside = (pos < Sc)[:, None, None]
    at = pos.clamp(0, Sc - 1)
    ck[bidx, at] = torch.where(inside, k1.to(ck.dtype), ck[bidx, at])
    cv[bidx, at] = torch.where(inside, v1.to(cv.dtype), cv[bidx, at])
    valid = torch.arange(Sc, device=ck.device)[None] <= pos[:, None]
    return {"k": ck, "v": cv}, ck, cv, valid


# --------------------------------------------------------------------------- full blocks
def init_dense_layer(gen, cfg: ModelConfig, dtype, d_ff: Optional[int] = None,
                     n: Stack = None) -> dict:
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


def init_moe_layer(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": _zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": init_attn_params(gen, cfg, dtype, n),
        "moe": moe_lib.init_moe_params(gen, cfg.moe, cfg.d_model, dtype, n),
    }


def apply_moe(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    """Attention, then ``x + moe(rms_norm(x, ln2))``; returns the router's aux loss."""
    h, new_cache = attn_sub(L.rms_norm(x, p["ln1"], ctx.cfg.norm_eps), p["attn"], ctx,
                            layer_type, mode, cache)
    x = x + h
    y, aux = moe_lib.moe_block(L.rms_norm(x, p["ln2"], ctx.cfg.norm_eps), p["moe"],
                               ctx.cfg.moe, ctx.cfg.act, dispatch=ctx.moe_dispatch,
                               mesh=ctx.mesh)
    return x + y, aux, new_cache


def init_ssm_layer(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "mixer": ssm_lib.init_mamba2_params(gen, cfg.ssm, cfg.d_model, dtype, n),
    }


def _init_ssm_cache(cfg: ModelConfig, B: int, ssm_cfg, dtype, device) -> dict:
    H = ssm_cfg.n_heads(cfg.d_model)
    width = ssm_cfg.d_inner(cfg.d_model) + 2 * ssm_cfg.n_groups * ssm_cfg.d_state
    return {
        "ssm_state": torch.zeros((B, H, ssm_cfg.head_dim, ssm_cfg.d_state),
                                 dtype=torch.float32, device=device),
        "conv_state": torch.zeros((B, ssm_cfg.d_conv - 1, width), dtype=dtype, device=device),
    }


def apply_ssm(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    """The Mamba-2 mixer as a residual block.  Decode writes the new SSD
    state and convolution window into ``cache`` in place."""
    cfg = ctx.cfg
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x + ssm_lib.mamba2_mixer(xn, p["mixer"], cfg.ssm, cfg.d_model), zero, None
    if mode == "prefill":
        y, state, conv_state = ssm_lib.mamba2_mixer_with_state(xn, p["mixer"], cfg.ssm,
                                                               cfg.d_model)
        return x + y, zero, {"ssm_state": state, "conv_state": conv_state}
    if mode != "decode":
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    y, state, conv_state = ssm_lib.mamba2_decode_step(xn[:, 0], cache["ssm_state"],
                                                      cache["conv_state"], p["mixer"],
                                                      cfg.ssm, cfg.d_model)
    cache["ssm_state"].copy_(state)
    cache["conv_state"].copy_(conv_state)
    return x + y[:, None], zero, cache


def init_block_cache(cfg: ModelConfig, B: int, layer_type: str, ctx: Ctx, dtype,
                     device) -> dict:
    """Cache structure for one layer (matches what prefill / decode produce)."""
    if cfg.family == "ssm":
        return _init_ssm_cache(cfg, B, cfg.ssm, dtype, device)
    if cfg.family == "hybrid":
        raise NotImplementedError("the hybrid cache is not ported to repro_torch yet "
                                  "(ROADMAP.md, queue 1, item 11: the other families)")
    return _init_attn_cache(cfg, B, layer_type, ctx, dtype, device)
