"""Decode attention: one new token's query against a KV cache.

``decode_attention`` takes q [B, H, hd] and k_cache, v_cache [B, S, KV, hd]
(bf16 or f32, H a multiple of KV: query head h reads KV head h // (H // KV)),
valid_mask [B, S] (bool) and n_live [B] (int32, or None for S), and returns
the attention output [B, H, hd] in the cache's type.  On CUDA tensors it
launches the kernels of csrc/decode_attention.cu; on CPU tensors it runs
:func:`decode_attention_plain`, the JAX package's einsums
(repro/models/layers.py:286 ``decode_attention``, which has no Pallas
kernel).

The function: slot s of row b is valid where ``s < n_live[b]`` and
``valid_mask[b, s]``; scores in f32 from the stored values times ``scale``
(default 1/sqrt(hd)); an invalid slot's score is the finite ``NEG_INF``;
softmax in f32, p kept in f32 into P.V, f32 sums, the output rounded once to
the cache's type.  A row with no valid slot comes out as the mean of V over
all S slots (the uniform softmax).  ``n_live`` only lets the kernel stop
reading: a caller passes a bound at or past each row's last valid slot.

The kernel reads the cache in place, in its own type: it takes any strides
whose last dim is 1 and whose others are whole 16-byte steps, and raises on
a cache it would have to copy.  It creates no host tensor and never waits
for the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed.annotate import is_dtensor
from repro_torch.kernels import _build
# the reference's masked score, and the head dims both attention kernels build
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF

#: query heads a KV head may serve (the repo's configs: 1 to 8)
MAX_GROUP = 8
_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
#: slots a split CTA reads at most; halved down to MIN_CHUNK while the grid
#: would hold fewer than GRID_TARGET CTAs (a few waves of the card's 132 SMs)
CHUNK, MIN_CHUNK, GRID_TARGET = 256, 64, 1024


def live_mask(valid_mask: torch.Tensor, n_live: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, S] bool: the slots the function attends to (``valid_mask`` and
    below ``n_live``)."""
    if n_live is None:
        return valid_mask
    S = valid_mask.shape[1]
    return valid_mask & (torch.arange(S, device=valid_mask.device)[None] < n_live[:, None])


def scores_plain(q: torch.Tensor, k_cache: torch.Tensor, valid_mask: torch.Tensor,
                 n_live: Optional[torch.Tensor] = None, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """[B, KV, G, S] f32 scores, an invalid slot's ``NEG_INF`` (a Python
    float: no tensor is made on the host)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * scale
    return torch.where(live_mask(valid_mask, n_live)[:, None, None, :], s, NEG_INF)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid_mask: torch.Tensor, n_live: Optional[torch.Tensor] = None,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the reference's einsums (f32 scores, softmax,
    p in f32 into P.V)."""
    B, H, hd = q.shape
    s = scores_plain(q, k_cache, valid_mask, n_live, scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(v_cache.dtype)


def decode_attention_partials_plain(q, k_cache, v_cache, valid_mask, n_live=None, *,
                                    scale=None):
    """Plain version of :func:`decode_attention_partials`."""
    B, H, hd = q.shape
    s = scores_plain(q, k_cache, valid_mask, n_live, scale=scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float()) / l
    return o.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def _checked(q, k_cache, v_cache, valid_mask, n_live):
    """Raise on what the kernel does not take, on either device (the plain
    version takes the same); returns (B, S, H, KV, hd, k's strides, v's)."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid_mask", valid_mask), ("n_live", n_live)):
        if t is None and name == "n_live":
            continue
        if is_dtensor(t):  # a wrapper with no storage of its own
            raise TypeError(f"decode_attention {name}: a DTensor; the kernel takes each "
                            f"rank's local tensors (models.layers.decode_attention's "
                            f"shard_map)")
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"decode_attention {name}: expected a torch.Tensor, got "
                            f"{type(t).__name__}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4 or valid_mask.dim() != 2:
        raise ValueError(f"decode_attention: expected q [B, H, hd], caches [B, S, KV, hd] and "
                         f"valid_mask [B, S], got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}, {tuple(valid_mask.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in _DTYPE:
            raise TypeError(f"decode_attention {name}: expected bfloat16 or float32, "
                            f"got {t.dtype}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"decode_attention: q, k_cache, v_cache types differ: {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if valid_mask.dtype != torch.bool:
        raise TypeError(f"decode_attention valid_mask: expected bool, got {valid_mask.dtype}")
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B or k_cache.shape[3] != hd
            or tuple(valid_mask.shape) != (B, S)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache {tuple(v_cache.shape)}, valid_mask "
                         f"{tuple(valid_mask.shape)} do not fit [B, H, hd] / [B, S, KV, hd] / "
                         f"[B, S]")
    if n_live is not None and (n_live.dtype != torch.int32 or tuple(n_live.shape) != (B,)):
        raise ValueError(f"decode_attention n_live: expected int32 [{B}], got {n_live.dtype} "
                         f"{tuple(n_live.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: {H} query heads over {KV} KV heads; the kernel "
                         f"takes a multiple of KV up to {MAX_GROUP} a KV head")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} is not one of {HEAD_DIMS}")
    if S == 0:
        raise ValueError("decode_attention: an empty cache (S == 0)")
    return B, S, H, KV, hd, _in_place(k_cache), _in_place(v_cache)


def _in_place(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, slot, head) strides of a cache the kernel reads where it
    lies: 16-byte loads need the last dim dense and every other step, and
    the start, on 16 bytes.  Raises rather than copy."""
    esize = t.element_size()
    st = t.stride()
    if st[3] != 1 or any(s * esize % 16 for s in st[:3]) or t.data_ptr() % 16:
        raise ValueError(f"decode_attention: a cache with strides {st} at offset "
                         f"{t.data_ptr() % 16} of 16 bytes would have to be copied; the "
                         f"kernel reads the last dim dense and 16-byte-aligned rows in place")
    return st[0], st[1], st[2]


def _chunk(B: int, S: int, KV: int) -> int:
    """Slots a split CTA reads, from the shapes alone."""
    chunk = CHUNK
    while chunk > MIN_CHUNK and B * KV * -(-S // chunk) < GRID_TARGET:
        chunk //= 2
    return chunk


def _run(q, k_cache, v_cache, valid_mask, n_live, scale, partials: bool):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    B, S, H, KV, hd, ks, vs = _checked(q, k_cache, v_cache, valid_mask, n_live)
    dev = _build.same_device("decode_attention", q, k_cache, v_cache, valid_mask,
                             *(() if n_live is None else (n_live,)))
    if dev.type == "cpu":
        plain = decode_attention_partials_plain if partials else decode_attention_plain
        return plain(q, k_cache, v_cache, valid_mask, n_live, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: tensors on {dev} are not supported; the kernel "
                         f"takes CUDA tensors, the plain version CPU tensors")
    if B * KV > 65535:
        raise ValueError(f"decode_attention: B * KV = {B * KV} exceeds the grid")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    valid_mask = valid_mask.contiguous()
    n_live = None if n_live is None else n_live.contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    chunk = _chunk(B, S, KV)
    n_splits = -(-S // chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    # the splits' partials in one scratch tensor: acc [B * KV, n_splits, G,
    # hd], then m and l [B * KV, n_splits, G]
    n_part = B * KV * n_splits * (H // KV)
    part = torch.empty(n_part * (hd + 2), **f32)
    at = part.data_ptr()
    out = torch.empty((B, H, hd), dtype=torch.float32 if partials else q.dtype, device=dev)
    m = torch.empty((B, H), **f32) if partials else None
    l = torch.empty((B, H), **f32) if partials else None
    _build.launch("dsa_decode_attention", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), valid_mask.data_ptr(),
                  None if n_live is None else n_live.data_ptr(), out.data_ptr(),
                  at + n_part * hd * 4, at + n_part * (hd + 1) * 4, at,
                  None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
                  B, S, H, KV, hd, chunk, n_splits, *ks, *vs, valid_mask.stride(0),
                  float(scale), _DTYPE[q.dtype], int(partials), _build.stream(q))
    _build.count(decode_attention)
    return (out, m, l) if partials else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid_mask: torch.Tensor, n_live: Optional[torch.Tensor] = None, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention output [B, H, hd] in the cache's type; see the module
    docstring for the function."""
    return _run(q, k_cache, v_cache, valid_mask, n_live, scale, False)


def decode_attention_partials(q, k_cache, v_cache, valid_mask, n_live=None, *, scale=None):
    """(o [B, H, hd] f32, m [B, H], l [B, H]): the output before rounding,
    the row's largest score and its sum of exp(s - m) (S and ``NEG_INF``
    for a row with no valid slot), for combining the softmax over ranks
    that each hold a part of the cache's sequence."""
    return _run(q, k_cache, v_cache, valid_mask, n_live, scale, True)


decode_attention.launches = 0
