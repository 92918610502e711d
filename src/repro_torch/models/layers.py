"""Shared neural-net layers of the decoder: norms, rotary embeddings (M-RoPE
included), gated MLPs and attention, as plain functions over tensors and
parameter dicts (the JAX package's ``repro.models.layers``, in PyTorch).

Attention comes in three forms:

* ``attention``         -- prefill, online softmax chunked over KV blocks in
                           plain PyTorch (the reference's non-kernel baseline,
                           ``attn_impl="chunked"``);
* ``attention_trainable(impl="flash")`` -- the hand-written CUDA kernel
                           (``kernels/flash_attention.py``) forward, with a
                           backward that recomputes through ``attention``
                           (the reference's custom VJP);
* ``decode_attention``  -- one new token against a KV cache with a per-
                           sequence validity mask.

Under ``repro_torch.distributed.use_rules`` the tensors are DTensors on the
rules' mesh: ``ann`` lays out q, k and v as the reference does, the flash
kernel runs on each rank's (batch x head) shard and ``tp_comm=
"manual_bf16"`` runs the tensor-parallel MLP and attention output as
``shard_map``s (DTensor's ``local_map``) with a bf16 all-reduce.  Without a
context ``ann`` is the identity and every path is the plain one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.annotate import (
    _current,
    all_reduce_sum,
    ann,
    axis_index,
    full,
    replicate,
    shard_map,
    unflatten,
)
from repro_torch.distributed.sharding import P, _as_tuple
from repro_torch.kernels import flash_attention as _flash

NEG_INF = _flash.NEG_INF


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


def mrope_cos_sin(positions_thw: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions_thw [3, B, S] -> cos, sin [B, S, hd // 2].

    The hd // 2 frequency slots are split into (t, h, w) sections; each
    section rotates by its own position stream.  Text tokens set t = h = w."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    exps = torch.arange(0, half, dtype=torch.float32, device=positions_thw.device) / half
    freqs = 1.0 / (theta ** exps)
    ang_all = positions_thw.float()[..., None] * freqs  # [3, B, S, half]
    pieces = []
    start = 0
    for i, sec in enumerate(sections):
        pieces.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(pieces, dim=-1)  # [B, S, half]
    return torch.cos(ang), torch.sin(ang)


# --------------------------------------------------------------------------- mlp
def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return F.silu if name == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def gated_mlp(x: torch.Tensor, p: dict, act: str = "silu", tp_comm: str = "auto") -> torch.Tensor:
    """SwiGLU / GeGLU MLP.  p = {w1 [D, F], w3 [D, F], w2 [F, D]}.

    tp_comm="manual_bf16": the whole tensor-parallel block in a
    ``shard_map`` with the row-parallel partial sums cast to the model's
    dtype before the all-reduce (otherwise the f32 products would go on
    the wire, twice the bytes)."""
    fn = _act(act)
    if tp_comm == "manual_bf16":
        out = _tp_block_manual(x, p, fn)
        if out is not None:
            return out
    h = fn(x @ p["w1"]) * (x @ p["w3"])
    h = ann(h, "batch", None, "mlp")
    return _summed(h @ p["w2"])


def _summed(out: torch.Tensor) -> torch.Tensor:
    """A row-parallel product [B, S, D] laid out by the rules at once: its
    partial sums are all-reduced here (what GSPMD does in the reference),
    not carried as a DTensor ``Partial`` into the residual stream, where
    the next norm would all-reduce and the next matmul reshard them."""
    return ann(out, "batch", None, "embed")


def _tp_block_manual(x, p, fn):
    """Megatron-style column + row parallel MLP with a bf16 wire; None when
    no rules context is active or the FF dim isn't sharded."""
    ctx = _current()
    if ctx is None:
        return None
    mesh, rules = ctx
    w1_spec = rules.spec(p["w1"].shape, (None, "mlp"))
    if w1_spec[1] is None:
        return None
    x_spec = rules.spec(x.shape, ("batch", None, None))
    axis = w1_spec[1]

    def local(x_l, w1_l, w3_l, w2_l):
        h = fn(x_l @ w1_l) * (x_l @ w3_l)
        part = (h @ w2_l).to(x_l.dtype)  # cast BEFORE the wire
        return all_reduce_sum(part, mesh, axis)

    return shard_map(local, mesh, (x_spec, w1_spec, w1_spec, P(axis, None)), x_spec,
                     reduces=_as_tuple(axis))(x, p["w1"], p["w3"], p["w2"])


def row_parallel_out(o_flat: torch.Tensor, wo: torch.Tensor, tp_comm: str = "auto") -> torch.Tensor:
    """Attention output projection [B, S, H * hd] @ [H * hd, D], row-parallel
    with a bf16-wire all-reduce when tp_comm="manual_bf16" (the same
    rationale as gated_mlp)."""
    ctx = _current()
    if tp_comm != "manual_bf16" or ctx is None:
        return _summed(o_flat @ wo)
    mesh, rules = ctx
    wo_spec = rules.spec(wo.shape, ("qkv_flat", None))
    if wo_spec[0] is None:
        return _summed(o_flat @ wo)
    o_spec = rules.spec(o_flat.shape, ("batch", None, "qkv_flat"))
    if o_spec[2] is None:
        return _summed(o_flat @ wo)
    axis = wo_spec[0]

    def local(o_l, w_l):
        return all_reduce_sum((o_l @ w_l).to(o_l.dtype), mesh, axis)

    return shard_map(local, mesh, (o_spec, wo_spec), P(o_spec[0], None, None),
                     reduces=_as_tuple(axis))(o_flat, wo)


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
    qg = unflatten(q, 2, (KV, G))

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

    q [B, H, hd]; k_cache, v_cache [B, S, KV, hd]; valid_mask [B, S] bool.
    Under a rules context each rank attends over its own (batch x KV head x
    cache sequence) shard, and ranks that split the sequence combine their
    softmax sums (what GSPMD makes of the reference's einsums; DTensor's
    own einsums over these layouts need its slowest resharding search)."""
    ctx = _current()
    if ctx is None:
        return _decode_attention(q, k_cache, v_cache, valid_mask, scale, None)
    mesh, rules = ctx
    kv_spec = rules.spec(k_cache.shape, ("batch", "seq", "kv_heads", None))
    b_ax, s_ax, kv_ax = kv_spec[0], kv_spec[1], kv_spec[2]
    q_spec = P(b_ax, kv_ax, None)

    def local(q_l, k_l, v_l, m_l):
        return _decode_attention(q_l, k_l, v_l, m_l, scale,
                                 None if s_ax is None else (mesh, s_ax))

    return shard_map(local, mesh, (q_spec, kv_spec, kv_spec, P(b_ax, s_ax)), q_spec)(
        q, k_cache, v_cache, valid_mask)


def _decode_attention(q, k_cache, v_cache, valid_mask, scale, seq_split):
    """``decode_attention`` on one rank's tensors; ``seq_split`` (mesh,
    axes) when the cache's sequence is split over those mesh axes."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * scale
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    if seq_split is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    else:
        import torch.distributed as dist

        mesh, axes = seq_split
        m = s.amax(dim=-1, keepdim=True)
        for a in _as_tuple(axes):
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
        p = torch.exp(s - m)
        l = all_reduce_sum(p.sum(dim=-1, keepdim=True), mesh, axes)
        o = all_reduce_sum(torch.einsum("bkgs,bskh->bkgh", p, v_cache.float()), mesh,
                           axes) / l
    return o.reshape(B, H, hd).to(v_cache.dtype)


# --------------------------------------------------------------------------- flash wrapper
def _kv_heads_of(h0: int, n_local: int, H: int, KV: int, device) -> torch.Tensor:
    """The KV heads that query heads h0 .. h0 + n_local - 1 read, one per
    group of local query heads: the heads of whole groups where n_local
    is a multiple of the group size, the one head all of them share where
    it divides the group, and one head for each query head otherwise."""
    G = H // KV
    idx = torch.div(torch.arange(h0, h0 + n_local, device=device), G, rounding_mode="floor")
    if n_local % G == 0:
        return idx[::G]
    if G % n_local == 0:
        return idx[:1]
    return idx


def _per_rank(run, whole, q, k, v):
    """``run(q, k, v)`` per rank on its local (batch x head) shard when a
    rules context is active, else on the tensors as they are.

    KV heads sharded like the query heads: each rank's KV heads are the
    ones its query heads read.  KV heads replicated while the query heads
    are sharded: each rank takes the KV heads its GLOBAL query heads read
    (``_kv_heads_of``).  (The reference passes the replicated KV through,
    and its flash kernel then pairs local query head j with KV head j //
    (H_local / KV), the wrong one; where H_local < KV that group size is
    0.)  Any other split: ``whole(q, k, v)``."""
    ctx = _current()
    if ctx is None:
        return run(q, k, v)
    mesh, rules = ctx
    q_spec = rules.spec(q.shape, ("batch", None, "heads", None))
    kv_spec = rules.spec(k.shape, ("batch", None, "kv_heads", None))
    h_shard = rules.axis_size(q_spec[2])
    kv_shard = rules.axis_size(kv_spec[2])
    if kv_shard not in (1, h_shard):
        return whole(q, k, v)
    if kv_shard == h_shard:
        return shard_map(run, mesh, (q_spec, kv_spec, kv_spec), q_spec)(q, k, v)
    H, KV = q.shape[2], k.shape[2]

    def local(q_l, k_l, v_l):
        r = axis_index(mesh, q_spec[2])
        n_local = q_l.shape[2]
        idx = _kv_heads_of(r * n_local, n_local, H, KV, k_l.device)
        return run(q_l, k_l.index_select(2, idx), v_l.index_select(2, idx))

    return shard_map(local, mesh, (q_spec, kv_spec, kv_spec), q_spec)(q, k, v)


def _flash_call(q, k, v, causal, window, n_meta, q_offset=0):
    """The flash kernel forward with the reference backward
    (``_FlashRefBwd``), per rank (``_per_rank``); a split it cannot run
    per rank takes the direct call on the whole tensors, as the reference
    does."""
    def run(q, k, v):
        return _FlashRefBwd.apply(q, k, v, causal, window, n_meta, q_offset)

    return _per_rank(run, lambda q, k, v: run(full(q), full(k), full(v)), q, k, v)


class _FlashRefBwd(torch.autograd.Function):
    """Flash forward, reference backward (the JAX package's
    ``_flash_fwd_ref_bwd`` custom VJP).  The forward is the kernel (its
    plain version on CPU tensors); it runs again in every remat replay.  The
    backward recomputes through the chunked ``attention`` and differentiates
    it with ``torch.func.vjp``: there is no backward kernel, as in the
    reference.  The ``setup_context`` form lets ``torch.func`` transforms
    call it: the kernel then sees plain tensors, not functorch wrappers."""

    @staticmethod
    def forward(q, k, v, causal, window, n_meta, q_offset):
        return _flash.flash_attention(q, k, v, causal=causal, window=window, n_meta=n_meta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, n_meta, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, n_meta, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, n_meta, q_offset = ctx.args
        _, vjp = torch.func.vjp(
            lambda q, k, v: attention(q, k, v, causal=causal, window=window, n_meta=n_meta,
                                      q_offset=q_offset),
            q, k, v)
        return (*vjp(g), None, None, None, None)


def attention_trainable(q, k, v, *, causal: bool = True, window: int = 0, n_meta: int = 0,
                        q_offset: int = 0, impl: str = "chunked"):
    """Attention with a selectable implementation: "chunked" (plain PyTorch,
    the baseline) or "flash" (the CUDA kernel forward, reference backward)."""
    if impl == "flash":
        return _flash_call(q, k, v, causal, window, n_meta, q_offset)

    # per rank too: DTensor's dispatch of each op of the block loop costs
    # more host time than the op, and the grouped-query reshape regathers
    # heads a rank does not need (a split it cannot run per rank takes
    # the DTensors as they are)
    def run(q, k, v):
        return attention(q, k, v, causal=causal, window=window, n_meta=n_meta,
                         q_offset=q_offset)

    return _per_rank(run, run, q, k, v)


# --------------------------------------------------------------------------- qkv projection helpers
def project_qkv(x: torch.Tensor, p: dict, cfg, *, qk_norm_p: Optional[dict] = None):
    """x [B, S, D] -> q [B, S, H, hd], k, v [B, S, KV, hd] (+ optional
    per-head RMS qk-norm)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = unflatten(x @ p["wq"], 2, (H, hd))
    k = unflatten(x @ p["wk"], 2, (KV, hd))
    v = unflatten(x @ p["wv"], 2, (KV, hd))
    if qk_norm_p is not None:
        q = rms_norm(q, qk_norm_p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, qk_norm_p["k_norm"], cfg.norm_eps)
    q = ann(q, "batch", None, "heads", None)
    k = ann(k, "batch", None, "kv_heads", None)
    v = ann(v, "batch", None, "kv_heads", None)
    return q, k, v


def unembed(x: torch.Tensor, table: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Logits head in f32.  table is [V, D] if transpose (tied) else [D, V]."""
    w = table.T if transpose else table
    return (x @ w.to(x.dtype)).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over masked positions.  logits [B, S, V] f32, labels [B, S] int.
    The gold logit is gathered from replicated logits (DTensor's gather
    along a vocab-sharded dim fails)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(replicate(logits), labels.long()[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
