"""Forward flash attention (the model stack's prefill kernel).

``flash_attention`` takes q [B, Sq, H, hd] and k, v [B, Skv, KV, hd] (bf16 or
f32, H a multiple of KV: query head h reads KV head h // (H // KV)) and
returns the attention output [B, Sq, H, hd] in q's type.  On CUDA tensors it
launches a kernel of csrc/flash_attention.cu, which replaces the JAX package's
Pallas ``flash_attention`` (repro/kernels/flash_attention.py:72): for bf16
``flash_attention_wgmma_kernel`` (Hopper tensor cores through wgmma, TMA
loads), for f32 ``flash_attention_f32_kernel`` (CUDA cores: f32 must hold
1e-5, which tensor cores cannot).  On CPU tensors it runs
:func:`flash_attention_plain`.

The function, as the reference computes it: scores in f32 scaled by
``scale`` (default 1/sqrt(hd)); masked scores are the finite ``NEG_INF``;
``causal`` keeps keys at or before the query's position; with ``window > 0``
a key is kept only where ``q_pos - k_pos < window`` or ``k_pos < n_meta``
(hymba's always-visible meta prefix); positions start at 0 for q and k.
Softmax probabilities are rounded to v's type before P.V, which accumulates
in f32; the output is ``acc / max(l, 1e-30)``.  A row with no visible key at
all (only ``Sq > Skv`` with a window makes one) comes out as the mean of V.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.annotate import is_dtensor
from repro_torch.kernels import _build

NEG_INF = -1e30
#: head dims the kernel is built for (the repo's configs use 64, 128 and 256;
#: their reduced() forms 32)
HEAD_DIMS = (32, 64, 128, 256)
_ENTRY = {torch.bfloat16: "dsa_flash_attention_bf16", torch.float32: "dsa_flash_attention_f32"}


def mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool, window: int,
               n_meta: int) -> torch.Tensor:
    """[len(q_pos), len(k_pos)] bool: which keys each query may attend to."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    m = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        in_window = (qp - kp) < window
        if n_meta > 0:
            in_window |= kp < n_meta  # meta tokens are always attendable
        m &= in_window
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, n_meta: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the same function and numerics in one pass
    (f32 scores, the same mask, p rounded to v's type, f32 accumulation)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    mask = mask_block(torch.arange(Sq, device=q.device), torch.arange(Skv, device=q.device),
                      causal=causal, window=window, n_meta=n_meta)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (float4 loads of the f32 kernel, TMA
    of the bf16 one)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, n_meta: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention output [B, Sq, H, hd] of q [B, Sq, H, hd] against k, v
    [B, Skv, KV, hd]; see the module docstring for the function."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if is_dtensor(t):  # a wrapper with no storage of its own
            raise TypeError(f"flash_attention {name}: a DTensor; the kernel takes each "
                            f"rank's local tensors (models.layers._flash_call's shard_map)")
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention {name}: expected a 4-D tensor, got "
                             f"{getattr(t, 'shape', type(t).__name__)}")
        if t.dtype not in _ENTRY:
            raise TypeError(f"flash_attention {name}: expected bfloat16 or float32, "
                            f"got {t.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v types differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B, Sq, H, hd] / [B, Skv, KV, hd]")
    Skv, KV = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a multiple of {KV} "
                         f"KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of {HEAD_DIMS}")
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv == 0)")
    dev = _build.same_device("flash_attention", q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, n_meta=n_meta,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {dev} are not supported; the "
                         f"kernel takes CUDA tensors, the plain version CPU tensors")
    # the grid's second dimension (at most 65535): B * H for f32, the
    # 64-row query tiles for bf16
    if (B * H if q.dtype == torch.float32 else -(-Sq // 64)) > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} or Sq = {Sq} exceeds the grid")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if Sq:
        _build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, Sq, Skv, H, KV, hd, float(scale), int(causal),
                      int(window), int(n_meta), _build.stream(q))
        _build.count(flash_attention)
    return out


flash_attention.launches = 0
