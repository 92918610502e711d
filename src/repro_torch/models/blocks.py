"""Block definitions: dense (with gemma3's local windows), MoE, Mamba-2 and
hymba's hybrid (attention and SSM heads side by side).

Each block is a pair of plain functions:

* ``init_*_layer(gen, cfg, ...) -> params``  (one layer; ``n`` stacks them)
* ``apply_*(x, p, ctx, mode, cache) -> (x, aux, new_cache)``

``mode`` is "train", "prefill" or "decode".  Caches are dicts of tensors;
"train" writes none, "prefill" writes a fresh cache and "decode" updates
one token IN PLACE (the reference returns new arrays; its server
donates the old ones, so nothing reads them again).  A "local" layer with a
window keeps a ring cache of ``n_meta + window`` slots with each slot's
absolute position (-1: empty).  An SSM layer's cache is its f32 SSD state
and its convolution window; a hybrid layer's is ``{"attn": ..., "ssm":
...}``, one of each.  A latent-attention layer (``cfg.mla``, DeepSeek-V2)
caches ``{"c_kv": [B, S, kv_lora_rank], "k_pe": [B, S, rope dims]}``, the
normalised latent and the roped key shared by all heads, in place of each
head's K and V.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.annotate import (
    _current,
    ann,
    axis_index,
    full,
    is_dtensor,
    shard_map,
    unflatten,
)
from repro_torch.distributed.sharding import P, _as_tuple
from repro_torch.kernels import mla_decode as _mla_kernel
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.obs.spans import stage


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
    """Self-attention sub-block (no residual / norm).  x [B, S, D] or [B, 1, D].
    A ``model.attention`` stage span."""
    with stage("model.attention", mode):
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
            o = L.decode_attention(q[:, 0], k_all, v_all, valid,
                                   n_live=_live_bound(ctx, layer_type))[:, None]
        o = ann(o, "batch", None, "heads", None)
        # laid out as wo's rows: where the heads do not divide the model axis
        # (and their flat width does) the gradient is gathered here, since
        # DTensor cannot split a sharded flat width back into heads
        o = ann(o.reshape(B, S, H * hd), "batch", None, "qkv_flat")
        out = L.row_parallel_out(o, p["wo"], ctx.tp_comm)
        return out, new_cache


def _write_prefill_cache(cfg: ModelConfig, ctx: Ctx, layer_type: str, k, v) -> dict:
    B, S = k.shape[0], k.shape[1]
    cache = _init_attn_cache(cfg, B, layer_type, ctx, k.dtype, k.device)
    # the writes run on whole tensors (DTensor loses a sliced write into a
    # sharded sequence dim and has no rule for an indexed one); the cache
    # is then laid out by its specs
    k, v = full(k), full(v)
    ck, cv = cache["k"], cache["v"]
    if not _is_ring(layer_type, ctx):
        ck[:, :S] = k
        cv[:, :S] = v
        return {"k": ann(ck, "batch", "seq", "kv_heads", None),
                "v": ann(cv, "batch", "seq", "kv_heads", None)}
    cpos = cache["pos"]
    n_meta, W = ctx.n_meta, ctx.window
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
    return {"k": ann(ck, "batch", "seq", "kv_heads", None),
            "v": ann(cv, "batch", "seq", "kv_heads", None), "pos": ann(cpos, "batch", None)}


def _decode_cache_update(cfg, ctx: Ctx, layer_type: str, cache: dict, k1, v1):
    """k1, v1 [B, KV, hd] for the current token at position ctx.lengths.

    Writes in place.  A ring cache writes slot n_meta + (pos - n_meta) % W
    (a meta position its own slot) and attends to the slots whose position
    is within the window, or a meta token.  In a full cache a position past
    the end (an idle slot keeps counting up) is dropped, as JAX drops an
    out-of-range ``.at[].set``: the row is rewritten with what it holds,
    with no host sync and no out-of-range index on the card.

    Under a rules context each rank writes its own shard of the cache (a
    ``shard_map``): its batch rows, its KV heads and, where the cache's
    sequence dim is sharded, the slots it holds."""
    ring = _is_ring(layer_type, ctx)
    Sc = cache["k"].shape[1]
    leaves = [cache["k"], cache["v"]] + ([cache["pos"]] if ring else [])
    rules_ctx = _current()
    if rules_ctx is None:
        valid = _cache_write(ctx, ring, Sc, None, k1, v1, ctx.lengths, *leaves)
    else:
        if not all(is_dtensor(t) for t in leaves):
            raise TypeError("under a rules context the cache must be laid out by the rules "
                            "(a DTensor from prefill or init_cache): each rank writes its "
                            "own shard in place")
        mesh, rules = rules_ctx
        # the new token's k / v, the lengths and the mask follow the cache's
        # own layout (its KV heads lose "model" where "seq" took it); a
        # ring's positions keep theirs, whole along the sequence (written
        # in place, so the next step reads them)
        c_spec = rules.spec(cache["k"].shape, ("batch", "seq", "kv_heads", None))
        kv_spec, b_spec = P(c_spec[0], c_spec[2], None), P(c_spec[0])
        row_spec = P(c_spec[0], c_spec[1])
        in_specs = (kv_spec, kv_spec, b_spec, c_spec, c_spec) + (
            (rules.spec(cache["pos"].shape, ("batch", None)),) if ring else ())
        valid = shard_map(
            lambda *a: _cache_write(ctx, ring, Sc, (mesh, _as_tuple(c_spec[1])), *a), mesh,
            in_specs, row_spec)(k1, v1, ctx.lengths, *leaves)
    new_cache = {"k": cache["k"], "v": cache["v"]}
    if ring:
        new_cache["pos"] = cache["pos"]
    return new_cache, cache["k"], cache["v"], valid


def _live_bound(ctx: Ctx, layer_type: str):
    """The decode attention's bound on live slots: a full cache holds slots
    [0, lengths], so ``lengths + 1`` (past the cache's end where an idle
    row keeps counting: the kernel reads no slot past either); every slot
    of a ring may be live (None).  One op in every layer, so that each
    layer's trip runs the same ops (``op_cost.counted_range``)."""
    return None if _is_ring(layer_type, ctx) else (ctx.lengths + 1).to(torch.int32)


def _cache_write(ctx: Ctx, ring: bool, Sc: int, seq, k1, v1, pos, ck, cv, cpos=None):
    """The decode write into (a shard of) a cache; returns the validity mask
    [B, S] of the slots held.  ``seq`` is (mesh, axes) when the tensors are
    one rank's shards, the sequence dim split over ``axes``; a ring's
    positions ``cpos`` are whole along the sequence on every rank."""
    B, Sl = ck.shape[0], ck.shape[1]
    off = 0
    if seq is not None and seq[1]:
        off = axis_index(seq[0], seq[1]) * Sl
    bidx = torch.arange(B, device=ck.device)
    pos = pos.long()
    if ring:
        n_meta, W = ctx.n_meta, ctx.window
        ring_slot = torch.where(pos < n_meta, pos, n_meta + (pos - n_meta) % W)
        slot = ring_slot - off
    else:
        slot = torch.where(pos < Sc, pos, torch.full_like(pos, -1)) - off
    # a write that falls outside the slots held rewrites a row with what it holds
    inside = ((slot >= 0) & (slot < Sl))
    at = slot.clamp(0, Sl - 1)
    ck[bidx, at] = torch.where(inside[:, None, None], k1.to(ck.dtype), ck[bidx, at])
    cv[bidx, at] = torch.where(inside[:, None, None], v1.to(cv.dtype), cv[bidx, at])
    if ring:
        cpos[bidx, ring_slot] = pos.to(cpos.dtype)
        held = cpos[:, off:off + Sl]
        in_window = (pos[:, None] - held) < W
        is_meta = (held >= 0) & (held < n_meta)
        return (held >= 0) & (held <= pos[:, None]) & (in_window | is_meta)
    return (off + torch.arange(Sl, device=ck.device))[None] <= pos[:, None]


# --------------------------------------------------------------------------- latent attention sub-block
def init_mla_params(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    """DeepSeek-V2's projections, each 2-D with its contraction first: q
    ``wq`` [D, H (dn + dr)], the latent and shared roped key ``wkv_a`` [D,
    r + dr], the latent's norm, the heads' nope keys and values ``wkv_b``
    [r, H (dn + dv)] (each head's dn key columns, then its dv value
    columns) and ``wo`` [H dv, D]."""
    m, H, D = cfg.mla, cfg.num_heads, cfg.d_model
    p = {"wq": _dense(gen, (D, H * m.qk_head_dim), dtype, n)}
    p["wkv_a"] = _dense(gen, (D, m.latent_dim), dtype, n)
    p["kv_norm"] = _zeros((m.kv_lora_rank,), dtype, n, gen.device)
    p["wkv_b"] = _dense(gen, (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)), dtype,
                        n)
    p["wo"] = _dense(gen, (H * m.v_head_dim, D), dtype, n)
    return p


def _init_latent_cache(cfg: ModelConfig, B: int, ctx: Ctx, dtype, device) -> dict:
    m, S = cfg.mla, ctx.max_cache_len
    return {"c_kv": torch.zeros((B, S, m.kv_lora_rank), dtype=dtype, device=device),
            "k_pe": torch.zeros((B, S, m.qk_rope_head_dim), dtype=dtype, device=device)}


def mla_sub(x: torch.Tensor, p: dict, ctx: Ctx, layer_type: str, mode: str,
            cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """Latent attention (DeepSeek-V2, arXiv:2405.04434; no residual or norm).
    q = x Wq split into nope and rope dims; [c_kv | k_pe] = x Wkv_a, c_kv
    RMS-normalised; q's and k_pe's rope dims roped (k_pe one head, shared);
    softmax scale ``layers.mla_softmax_scale``.  Train and prefill run the
    expanded form: [k_nope | v] = c_kv Wkv_b, then causal attention over
    [k_nope | k_pe] (``_mla_expanded``).  Decode runs the absorbed form
    against the latent cache: q_lat[h] = q_nope[h] W_UK[h]^T, scores
    q_lat . c_kv + q_pe . k_pe over the live slots (the kernel of
    ``kernels/mla_decode.py``), o = (p c_kv) W_UV[h], then Wo.  A
    ``model.mla`` stage span."""
    with stage("model.mla", mode):
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
        cfg, m = ctx.cfg, ctx.cfg.mla
        B, S, _ = x.shape
        H, dn, dr, dv, r = (cfg.num_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                            m.v_head_dim, m.kv_lora_rank)
        q = unflatten(x @ p["wq"], 2, (H, dn + dr))
        kv = x @ p["wkv_a"]
        c_kv = L.rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
        cos, sin = ctx.rope(layer_type)
        q_pe = L.apply_rope(q[..., dn:], cos, sin)
        k_pe = L.apply_rope(kv[..., None, r:], cos, sin)  # [B, S, 1, dr]
        scale = L.mla_softmax_scale(cfg)
        if mode in ("train", "prefill"):
            kv_b = unflatten(c_kv @ p["wkv_b"], 2, (H, dn + dv))
            qf = torch.cat([q[..., :dn], q_pe], dim=-1)
            k = torch.cat([kv_b[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
            o = _mla_expanded(qf, k, kv_b[..., dn:], scale, ctx)
            new_cache = (_write_prefill_latent(cfg, ctx, c_kv, k_pe[:, :, 0])
                         if mode == "prefill" else None)
        else:  # decode: S == 1
            w = p["wkv_b"].reshape(r, H, dn + dv)
            q_lat = torch.einsum("bhd,rhd->bhr", q[:, 0, :, :dn], w[..., :dn])
            o_lat = _latent_decode(ctx, cache, torch.cat([q_lat, q_pe[:, 0]], dim=-1),
                                   c_kv[:, 0], k_pe[:, 0, 0], scale)
            o = torch.einsum("bhr,rhd->bhd", o_lat, w[..., dn:])[:, None]
            new_cache = cache
        o = ann(o.reshape(B, S, H * dv), "batch", None, "qkv_flat")
        return L.row_parallel_out(o, p["wo"], ctx.tp_comm), new_cache


def _mla_expanded(q, k, v, scale: float, ctx: Ctx) -> torch.Tensor:
    """Causal attention of q, k [B, S, H, dn + dr] and v [B, S, H, dv] as one
    attention call of one head width: zero dims appended, which is exact
    (a zero dim adds nothing to a score, a zero column of v gives a zero
    column of the output, cut off after), to the flash kernel's smallest
    built head dim that holds both, or to the wider of the two."""
    dq, dv = q.shape[-1], v.shape[-1]
    hd = max(dq, dv)
    if ctx.attn_impl == "flash":
        hd = min(d for d in HEAD_DIMS if d >= hd)
    q, k, v = F.pad(q, (0, hd - dq)), F.pad(k, (0, hd - dq)), F.pad(v, (0, hd - dv))
    o = L.attention_trainable(q, k, v, causal=ctx.causal, impl=ctx.attn_impl, scale=scale)
    return o[..., :dv]


def _write_prefill_latent(cfg: ModelConfig, ctx: Ctx, c_kv, k_pe) -> dict:
    """A fresh latent cache with the prompt's S tokens in slots [0, S)."""
    B, S = c_kv.shape[0], c_kv.shape[1]
    cache = _init_latent_cache(cfg, B, ctx, c_kv.dtype, c_kv.device)
    cache["c_kv"][:, :S] = full(c_kv)
    cache["k_pe"][:, :S] = full(k_pe)
    return {k: ann(t, "batch", None, None) for k, t in cache.items()}


def _latent_decode(ctx: Ctx, cache: dict, q_abs, c1, kpe1, scale: float) -> torch.Tensor:
    """The token's latent c1 [B, r] and roped key kpe1 [B, dr] written into
    the cache at ``ctx.lengths`` in place, then the absorbed query q_abs
    [B, H, r + dr] against the cache's live slots: o_lat [B, H, r].  Under a
    rules context each rank does both on its batch shard (a
    ``shard_map``)."""
    n_live = _live_bound(ctx, "global")
    rules_ctx = _current()
    if rules_ctx is None:
        return _latent_decode_local(q_abs, c1, kpe1, ctx.lengths, n_live, cache["c_kv"],
                                    cache["k_pe"], scale)
    mesh, rules = rules_ctx
    c_spec = rules.spec(cache["c_kv"].shape, ("batch", None, None))
    b = c_spec[0]
    return shard_map(lambda *a: _latent_decode_local(*a, scale), mesh,
                     (P(b, None, None), P(b, None), P(b, None), P(b), P(b), c_spec,
                      rules.spec(cache["k_pe"].shape, ("batch", None, None))),
                     P(b, None, None))(q_abs, c1, kpe1, ctx.lengths, n_live, cache["c_kv"],
                                       cache["k_pe"])


def _latent_decode_local(q_abs, c1, kpe1, pos, n_live, c_kv, k_pe, scale: float):
    """``_latent_decode`` on one rank's tensors.  A position past the
    cache's end (an idle row keeps counting) writes nothing: the row is
    rewritten with what it holds, with no host sync."""
    B, Sc = c_kv.shape[0], c_kv.shape[1]
    pos = pos.long()
    bidx = torch.arange(B, device=c_kv.device)
    inside = (pos < Sc)[:, None]
    at = pos.clamp(max=Sc - 1)
    c_kv[bidx, at] = torch.where(inside, c1.to(c_kv.dtype), c_kv[bidx, at])
    k_pe[bidx, at] = torch.where(inside, kpe1.to(k_pe.dtype), k_pe[bidx, at])
    return _mla_kernel.mla_decode(q_abs, c_kv, k_pe, n_live, scale=scale)


# --------------------------------------------------------------------------- full blocks
def init_dense_layer(gen, cfg: ModelConfig, dtype, d_ff: Optional[int] = None,
                     n: Stack = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": _zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": _init_attention(gen, cfg, dtype, n),
        "mlp": init_mlp_params(gen, cfg.d_model, d_ff or cfg.d_ff, dtype, n),
    }


def _init_attention(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    return (init_mla_params if cfg.mla is not None else init_attn_params)(gen, cfg, dtype, n)


def _attention(x, p, ctx: Ctx, layer_type: str, mode: str, cache):
    """The layer's attention sub-block: latent (``cfg.mla``) or heads."""
    sub = mla_sub if ctx.cfg.mla is not None else attn_sub
    return sub(x, p, ctx, layer_type, mode, cache)


def apply_dense(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    h, new_cache = _attention(L.rms_norm(x, p["ln1"], ctx.cfg.norm_eps), p["attn"], ctx,
                              layer_type, mode, cache)
    x = x + h
    x = x + L.gated_mlp(L.rms_norm(x, p["ln2"], ctx.cfg.norm_eps), p["mlp"], ctx.cfg.act,
                        tp_comm=ctx.tp_comm)
    x = ann(x, "batch", None, "embed")
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


def init_moe_layer(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": _zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": _init_attention(gen, cfg, dtype, n),
        "moe": moe_lib.init_moe_params(gen, cfg.moe, cfg.d_model, dtype, n),
    }


def apply_moe(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    """Attention, then ``x + moe(rms_norm(x, ln2))``; returns the router's aux loss."""
    h, new_cache = _attention(L.rms_norm(x, p["ln1"], ctx.cfg.norm_eps), p["attn"], ctx,
                              layer_type, mode, cache)
    x = x + h
    y, aux = moe_lib.moe_block(L.rms_norm(x, p["ln2"], ctx.cfg.norm_eps), p["moe"],
                               ctx.cfg.moe, ctx.cfg.act, dispatch=ctx.moe_dispatch,
                               mesh=ctx.mesh)
    return ann(x + y, "batch", None, "embed"), aux, new_cache


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
        with stage("model.ssm", mode):
            y = ssm_lib.mamba2_mixer(xn, p["mixer"], cfg.ssm, cfg.d_model)
        return x + y, zero, None
    if mode == "prefill":
        with stage("model.ssm", mode):
            y, state, conv_state = ssm_lib.mamba2_mixer_with_state(xn, p["mixer"], cfg.ssm,
                                                                   cfg.d_model)
        return x + y, zero, {"ssm_state": state, "conv_state": conv_state}
    if mode != "decode":
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    with stage("model.ssm", mode):
        y, state, conv_state = ssm_lib.mamba2_decode_step(xn[:, 0], cache["ssm_state"],
                                                          cache["conv_state"], p["mixer"],
                                                          cfg.ssm, cfg.d_model)
    cache["ssm_state"].copy_(state)
    cache["conv_state"].copy_(conv_state)
    return x + y[:, None], zero, cache


def init_hybrid_layer(gen, cfg: ModelConfig, dtype, n: Stack = None) -> dict:
    return {
        "ln1": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ln2": _zeros((cfg.d_model,), dtype, n, gen.device),
        "attn": init_attn_params(gen, cfg, dtype, n),
        "mixer": ssm_lib.init_mamba2_params(gen, cfg.hybrid.ssm, cfg.d_model, dtype, n),
        "attn_out_norm": _zeros((cfg.d_model,), dtype, n, gen.device),
        "ssm_out_norm": _zeros((cfg.d_model,), dtype, n, gen.device),
        "mlp": init_mlp_params(gen, cfg.d_model, cfg.d_ff, dtype, n),
    }


def apply_hybrid(x, p, ctx: Ctx, layer_type: str, mode: str, cache=None):
    """Hymba (arXiv:2411.13676): attention heads and SSM heads run side by
    side on the same normalised input; each output is RMS-normalised, the
    two are averaged, then the MLP runs.  The SSM heads use
    ``cfg.hybrid.ssm``.  Decode writes both caches in place."""
    cfg = ctx.cfg
    scfg = cfg.hybrid.ssm
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_a_cache = attn_sub(xn, p["attn"], ctx, layer_type, mode,
                                     cache["attn"] if cache else None)
    new_cache = None
    if mode == "train":
        with stage("model.ssm", mode):
            ssm_out = ssm_lib.mamba2_mixer(xn, p["mixer"], scfg, cfg.d_model)
    elif mode == "prefill":
        with stage("model.ssm", mode):
            ssm_out, state, conv_state = ssm_lib.mamba2_mixer_with_state(xn, p["mixer"], scfg,
                                                                         cfg.d_model)
        new_cache = {"attn": new_a_cache,
                     "ssm": {"ssm_state": state, "conv_state": conv_state}}
    else:
        s_cache = cache["ssm"]
        with stage("model.ssm", mode):
            y1, state, conv_state = ssm_lib.mamba2_decode_step(
                xn[:, 0], s_cache["ssm_state"], s_cache["conv_state"], p["mixer"], scfg,
                cfg.d_model)
        s_cache["ssm_state"].copy_(state)
        s_cache["conv_state"].copy_(conv_state)
        ssm_out = y1[:, None]
        new_cache = {"attn": new_a_cache, "ssm": s_cache}
    h = 0.5 * (L.rms_norm(attn_out, p["attn_out_norm"], cfg.norm_eps)
               + L.rms_norm(ssm_out, p["ssm_out_norm"], cfg.norm_eps))
    x = x + h
    x = x + L.gated_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg.act,
                        tp_comm=ctx.tp_comm)
    x = ann(x, "batch", None, "embed")
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


def init_block_cache(cfg: ModelConfig, B: int, layer_type: str, ctx: Ctx, dtype,
                     device) -> dict:
    """Cache structure for one layer (matches what prefill / decode produce)."""
    if cfg.family == "ssm":
        return _init_ssm_cache(cfg, B, cfg.ssm, dtype, device)
    if cfg.family == "hybrid":
        return {"attn": _init_attn_cache(cfg, B, layer_type, ctx, dtype, device),
                "ssm": _init_ssm_cache(cfg, B, cfg.hybrid.ssm, dtype, device)}
    if cfg.mla is not None:
        return _init_latent_cache(cfg, B, ctx, dtype, device)
    return _init_attn_cache(cfg, B, layer_type, ctx, dtype, device)
