"""Latent-attention decode (DeepSeek-V2's absorbed form): one new token's
query heads against a latent cache.

``mla_decode`` takes the absorbed query q [B, H, r + dr] (each head's
nope query times its W_UK, then its roped dims), the latent cache c_kv
[B, S, r] and the shared roped keys k_pe [B, S, dr] (bf16 or f32, each read
in place) and n_live [B] (int32), and returns o_lat [B, H, r] in q's type.
On CUDA tensors it launches the kernels of csrc/mla_decode.cu, built for
DeepSeek-V2's H = 16, r = 512 and dr = 64; on CPU tensors it runs
:func:`mla_decode_plain`, which takes any widths.  It replaces no Pallas
kernel: the JAX package has no latent attention.

The function: slot s of row b is live where ``s < n_live[b]``; its score
is ``(q[:r] . c_kv[s] + q[r:] . k_pe[s]) * scale`` in f32 from the
stored values; softmax in f32 over the live slots; ``o = sum_s p_s
c_kv[s]`` with f32 sums, rounded once to q's type.  A row with no live
slot comes out as the mean of c_kv over all S slots (the uniform softmax
over S scores of ``NEG_INF``, as ``decode_attention`` gives).

The kernel reads the caches in place, in their own type: any strides whose
last dim is 1 and whose others are whole 16-byte steps; it raises on a
cache it would have to copy.  It creates no host tensor and never waits
for the card.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.annotate import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import NEG_INF

#: the widths the kernel is built for (DeepSeek-V2's): query heads (the
#: tensor-core tile's 16 rows), the latent, the shared roped key
HEADS, LATENT, ROPE = 16, 512, 64
_DTYPE = {torch.bfloat16: 0, torch.float32: 1}
#: slots a split CTA reads at most (a multiple of the kernel's 64-slot
#: tile), halved down to TILE while the grid would hold fewer than
#: GRID_TARGET CTAs (two waves of the card's 132 SMs, one CTA an SM)
CHUNK, TILE, GRID_TARGET = 512, 64, 264


def live_mask(n_live: torch.Tensor, S: int) -> torch.Tensor:
    """[B, S] bool: the slots below each row's ``n_live``."""
    return torch.arange(S, device=n_live.device)[None] < n_live[:, None].long()


def mla_decode_plain(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
                     n_live: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 scores of the latent and the roped key,
    a masked slot's ``NEG_INF``, softmax in f32, p in f32 into P.C."""
    r = c_kv.shape[-1]
    s = (torch.einsum("bhr,bsr->bhs", q[..., :r].float(), c_kv.float())
         + torch.einsum("bhd,bsd->bhs", q[..., r:].float(), k_pe.float())) * scale
    s = torch.where(live_mask(n_live, c_kv.shape[1])[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, c_kv.float()).to(q.dtype)


def _checked(q, c_kv, k_pe, n_live):
    """Raise on what neither version takes; returns (B, S).  The kernel's
    built widths are checked where it runs (``mla_decode``): the plain
    version takes any."""
    for name, t in (("q", q), ("c_kv", c_kv), ("k_pe", k_pe), ("n_live", n_live)):
        if is_dtensor(t):  # a wrapper with no storage of its own
            raise TypeError(f"mla_decode {name}: a DTensor; the kernel takes each rank's "
                            f"local tensors (models.blocks._latent_decode's shard_map)")
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"mla_decode {name}: expected a torch.Tensor, got "
                            f"{type(t).__name__}")
    if q.dim() != 3 or c_kv.dim() != 3 or k_pe.dim() != 3:
        raise ValueError(f"mla_decode: expected q [B, H, r + dr], c_kv [B, S, r] and k_pe "
                         f"[B, S, dr], got {tuple(q.shape)}, {tuple(c_kv.shape)}, "
                         f"{tuple(k_pe.shape)}")
    for name, t in (("q", q), ("c_kv", c_kv), ("k_pe", k_pe)):
        if t.dtype not in _DTYPE:
            raise TypeError(f"mla_decode {name}: expected bfloat16 or float32, got {t.dtype}")
    if not q.dtype == c_kv.dtype == k_pe.dtype:
        raise TypeError(f"mla_decode: q, c_kv, k_pe types differ: {q.dtype}, {c_kv.dtype}, "
                        f"{k_pe.dtype}")
    B, S, r = c_kv.shape
    if (q.shape[0] != B or q.shape[2] != r + k_pe.shape[2]
            or tuple(k_pe.shape[:2]) != (B, S)):
        raise ValueError(f"mla_decode: shapes q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_pe {tuple(k_pe.shape)} do not fit [B, H, r + dr] / [B, S, r] / "
                         f"[B, S, dr]")
    if n_live.dtype != torch.int32 or tuple(n_live.shape) != (B,):
        raise ValueError(f"mla_decode n_live: expected int32 [{B}], got {n_live.dtype} "
                         f"{tuple(n_live.shape)}")
    if S == 0:
        raise ValueError("mla_decode: an empty cache (S == 0)")
    return B, S


def _in_place(t: torch.Tensor, name: str):
    """The (batch, slot) strides of a cache the kernel reads where it lies:
    16-byte loads need the last dim dense and every other step, and the
    start, on 16 bytes.  Raises rather than copy."""
    esize = t.element_size()
    st = t.stride()
    if st[2] != 1 or any(s * esize % 16 for s in st[:2]) or t.data_ptr() % 16:
        raise ValueError(f"mla_decode {name}: strides {st} at offset {t.data_ptr() % 16} of "
                         f"16 bytes would have to be copied; the kernel reads the last dim "
                         f"dense and 16-byte-aligned rows in place")
    return st[0], st[1]


def _chunk(B: int, S: int) -> int:
    """Slots a split CTA reads, from the shapes alone."""
    chunk = CHUNK
    while chunk > TILE and B * -(-S // chunk) < GRID_TARGET:
        chunk //= 2
    return chunk


def mla_decode(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor, n_live: torch.Tensor,
               *, scale: float) -> torch.Tensor:
    """o_lat [B, H, r] in q's type; see the module docstring."""
    B, S = _checked(q, c_kv, k_pe, n_live)
    dev = _build.same_device("mla_decode", q, c_kv, k_pe, n_live)
    if dev.type == "cpu":
        return mla_decode_plain(q, c_kv, k_pe, n_live, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"mla_decode: tensors on {dev} are not supported; the kernel takes "
                         f"CUDA tensors, the plain version CPU tensors")
    if (q.shape[1], c_kv.shape[2], k_pe.shape[2]) != (HEADS, LATENT, ROPE):
        raise ValueError(f"mla_decode: {q.shape[1]} heads over a latent of {c_kv.shape[2]} "
                         f"and a roped key of {k_pe.shape[2]}; the kernel is built for "
                         f"{HEADS}, {LATENT} and {ROPE}")
    if B > 65535:
        raise ValueError(f"mla_decode: B = {B} exceeds the grid")
    cs, ps = _in_place(c_kv, "c_kv"), _in_place(k_pe, "k_pe")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    n_live = n_live.contiguous()
    chunk = _chunk(B, S)
    n_splits = -(-S // chunk)
    # the splits' partials in one scratch tensor: acc [B, n_splits, H, 512],
    # then m and l [B, n_splits, H]
    n_part = B * n_splits * HEADS
    part = torch.empty(n_part * (LATENT + 2), dtype=torch.float32, device=dev)
    at = part.data_ptr()
    out = torch.empty((B, HEADS, LATENT), dtype=q.dtype, device=dev)
    _build.launch("dsa_mla_decode", q.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(),
                  n_live.data_ptr(), out.data_ptr(), at + n_part * LATENT * 4,
                  at + n_part * (LATENT + 1) * 4, at, B, S, chunk, n_splits, *cs, *ps,
                  float(scale), _DTYPE[q.dtype], _build.stream(q))
    _build.count(mla_decode)
    return out


mla_decode.launches = 0
