"""Public wrappers over the streaming kernels.

Handles any input shape and dtype (uint32 word view), the chunk and
shift-matrix choices of the CRC, and the device: every wrapper below runs
the CUDA kernels for CUDA tensors and their plain versions for CPU tensors
(there is no global backend switch and no fallback from one to the other).

Every function has a bit-exact oracle in ref.py.  ``compare``,
``compare_pattern``, ``fill_verify`` and ``delta_create`` read nothing back
to the host on CUDA tensors: their results stay on the card until the
caller reads them.  The word view has no padding, so the JAX package's mask
of padding words (only real words count) holds here by construction.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import batch_copy as _bc
from repro_torch.kernels import compare as _cmp
from repro_torch.kernels import crc32 as _crc
from repro_torch.kernels import delta_apply as _da
from repro_torch.kernels import delta_create as _dc
from repro_torch.kernels import dualcast as _dual
from repro_torch.kernels import fill as _fill
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import memcpy as _mc
from repro_torch.kernels import ref as _ref

LANES = 128


# --------------------------------------------------------------------------- word view
def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _bitcast_to_u32(x: torch.Tensor) -> torch.Tensor:
    """Flat uint32 view of ``x``'s bytes (a copy only if ``x`` is not
    contiguous, or starts inside a word of its storage)."""
    if _nbytes(x) % 4:
        raise ValueError(f"buffers must be 4-byte multiples, got {_nbytes(x)} "
                         f"bytes ({tuple(x.shape)} {x.dtype})")
    flat = x.contiguous().reshape(-1)
    if flat.storage_offset() * flat.element_size() % 4:
        flat = flat.clone()
    return flat.view(torch.uint32)


def to_words(x: torch.Tensor, row_multiple: int = 1) -> Tuple[torch.Tensor, int, tuple, torch.dtype]:
    """Bit-cast any tensor to a zero-padded [rows, 128] uint32 word grid,
    the layout of the JAX package's word-grid kernels."""
    flat = _bitcast_to_u32(x)
    n_words = flat.shape[0]
    rows = -(-n_words // LANES)
    rows = -(-rows // row_multiple) * row_multiple
    pad = rows * LANES - n_words
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=torch.uint32, device=flat.device)])
    return flat.reshape(rows, LANES), n_words, tuple(x.shape), x.dtype


def from_words(words: torch.Tensor, n_words: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The first ``n_words`` words of ``words`` viewed as ``dtype`` ``shape``."""
    return words.reshape(-1)[:n_words].view(dtype).reshape(shape)


def _pick_block_rows(rows: int, n_pe: int, target: int = 64) -> int:
    """Largest block_rows <= target such that n_pe * block_rows | rows."""
    for br in range(min(target, rows), 0, -1):
        if rows % (br * n_pe) == 0:
            return br
    return 1


# --------------------------------------------------------------------------- ops
def memcpy(x: torch.Tensor, *, n_pe: int = 1) -> torch.Tensor:
    flat = _bitcast_to_u32(x)
    out = _mc.memcpy_words(flat, n_pe=n_pe)
    return from_words(out, flat.shape[0], tuple(x.shape), x.dtype)


def _buffer_device(pattern, device):
    """Where a filled buffer goes: ``device``, else the pattern tensor's
    device, else CUDA."""
    if device is not None:
        return device
    return pattern.device if isinstance(pattern, torch.Tensor) else "cuda"


def fill(pattern, n_words: int, *, n_pe: int = 1, device=None) -> torch.Tensor:
    """Fill ``n_words`` uint32 words with a repeating 1/2/4-word pattern.
    ``pattern`` is an immediate (ints, or a tensor read once); the buffer
    goes on ``device``: by default the pattern tensor's device, else CUDA."""
    return _fill.fill_words(n_words, pattern, n_pe=n_pe, device=_buffer_device(pattern, device))


def fill_like(x: torch.Tensor, pattern_words=(0,), **kw) -> torch.Tensor:
    """Engine-backed buffer (re)initialization, e.g. grad-accumulator
    zeroing: ``x``'s shape and dtype, filled on ``x``'s device."""
    nbytes = _nbytes(x)
    kw.setdefault("device", x.device)
    words = fill(pattern_words, nbytes // 4, **kw)
    return from_words(words, nbytes // 4, tuple(x.shape), x.dtype)


def compare(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first-diff word index | -1), DSA completion-record style:
    a 0-d bool and a 0-d int32 on the operands' device."""
    return _cmp.compare_words(_bitcast_to_u32(a), _bitcast_to_u32(b))


def compare_pattern(a: torch.Tensor, pattern) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first word index that differs from the repeating 1/2/4-word
    ``pattern`` | -1) over ``a``'s word view, as ``compare`` returns it."""
    return _cmp.compare_pattern_words(_bitcast_to_u32(a), pattern)


def dualcast(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two copies of ``x`` (its shape and dtype) from one read of it."""
    flat = _bitcast_to_u32(x)
    d1, d2 = _dual.dualcast_words(flat)
    n, shape = flat.shape[0], tuple(x.shape)
    return from_words(d1, n, shape, x.dtype), from_words(d2, n, shape, x.dtype)


def fill_verify(pattern, n_words: int, *, device=None):
    """Fused fill + compare_pattern in ONE kernel launch: returns
    ``(filled, (ok, first_bad_idx))`` where ``filled`` is bit-identical to
    ``fill(pattern, n_words)`` and the pair matches
    ``compare_pattern(filled, pattern)``, computed in-kernel from the words
    just written.  ``device`` as for ``fill``."""
    filled, ok, first = _fused.fill_verify_words(n_words, pattern,
                                                 device=_buffer_device(pattern, device))
    return filled, (ok, first)


def delta_create(src: torch.Tensor, ref: torch.Tensor, *, cap: int = 1024):
    """Fixed-capacity delta record (offsets, data, count, overflow?)."""
    return _dc.delta_record_words(_bitcast_to_u32(src), _bitcast_to_u32(ref), cap)


def delta_apply(ref: torch.Tensor, offsets: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``ref`` with the record applied, in ``ref``'s shape and dtype.  The
    record's offsets are int32 and its data uint32 words (other 4-byte
    types are taken by their bits); it moves to ``ref``'s device."""
    flat = _bitcast_to_u32(ref)
    off = torch.as_tensor(offsets)
    if off.is_floating_point() or off.dtype == torch.bool:
        raise TypeError(f"delta_apply: offsets must be integers, got {off.dtype}")
    off = off.to(flat.device, torch.int32).reshape(-1).contiguous()
    words = _bitcast_to_u32(torch.as_tensor(data)).to(flat.device)
    out = _da.delta_apply_words(flat, off, words)
    return from_words(out, flat.shape[0], tuple(ref.shape), ref.dtype)


# --------------------------------------------------------------------------- crc32
_CRC_TABLES = _ref.make_crc_tables(4)
_cache_lock = threading.Lock()
_TABLES: Dict[torch.device, torch.Tensor] = {}
# Bounded LRU of crc32_combine shift matrices, keyed by chunk byte length and
# device.  Sweeps over many distinct sizes (long-running services) would
# otherwise grow this without limit: one matrix per size ever seen.
_SHIFT_CACHE: "collections.OrderedDict[Tuple[int, torch.device], torch.Tensor]" = (
    collections.OrderedDict())
_SHIFT_CACHE_MAX = 64


def _to_device(arr, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(arr.view("int32")).view(torch.uint32).to(device)
    if device.type == "cuda":
        # cached and then read from other streams: let the copy land first
        torch.cuda.current_stream(device).synchronize()
    return t


def _tables(device: torch.device) -> torch.Tensor:
    with _cache_lock:
        t = _TABLES.get(device)
        if t is None:
            t = _TABLES[device] = _to_device(_CRC_TABLES, device)
        return t


def _shift_mat(chunk_bytes: int, device: torch.device) -> torch.Tensor:
    key = (chunk_bytes, device)
    with _cache_lock:
        mat = _SHIFT_CACHE.get(key)
        if mat is None:
            mat = _to_device(_ref.crc32_shift_matrix(chunk_bytes), device)
            _SHIFT_CACHE[key] = mat
            while len(_SHIFT_CACHE) > _SHIFT_CACHE_MAX:
                _SHIFT_CACHE.popitem(last=False)  # evict least-recently-used
        else:
            _SHIFT_CACHE.move_to_end(key)
        return mat


def _pick_chunks(n_words: int, max_chunks: int = 256) -> int:
    """Largest C <= max_chunks dividing n_words (1 when none above 1 does):
    the JAX package's choice, so the chunk states match it."""
    c = 1
    for cand in range(1, max_chunks + 1):
        if n_words % cand == 0:
            c = cand
    return c


def _chunks(x: torch.Tensor, max_chunks: int) -> Tuple[torch.Tensor, int]:
    flat = _bitcast_to_u32(x)
    n_words = flat.shape[0]
    C = _pick_chunks(n_words, max_chunks)
    return flat.view(C, n_words // C), n_words


def _fold(states: torch.Tensor, n_words: int) -> torch.Tensor:
    C = states.shape[0]
    if C == 1:
        return states[0]
    mat = _shift_mat((n_words // C) * 4, states.device)
    if mat.is_cuda:
        # the LRU may evict (free) the matrix while this stream still reads it
        mat.record_stream(torch.cuda.current_stream(mat.device))
    return _crc.combine_chunk_crcs(states, mat)


def crc32(x: torch.Tensor, *, max_chunks: int = 256) -> torch.Tensor:
    """zlib-compatible CRC32 of the little-endian byte view (0-d uint32)."""
    data, n_words = _chunks(x, max_chunks)
    states = _crc.crc32_chunk_states(data, _tables(data.device))
    return _fold(states, n_words)


def copy_crc(x: torch.Tensor, *, max_chunks: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused memcpy + CRC32 in ONE kernel launch: returns ``(copy, crc)``
    where ``copy`` is bit-identical to ``memcpy(x)`` and ``crc`` matches
    ``crc32(x)``.  One read pass feeds both the write stream and the
    checksum, against two launches and two read passes unfused."""
    data, n_words = _chunks(x, max_chunks)
    states, dst = _fused.copy_crc_words(data, _tables(data.device))
    return from_words(dst, n_words, tuple(x.shape), x.dtype), _fold(states, n_words)


# --------------------------------------------------------------------------- batch copy (paged)
def _page_index(idx, n_pages: int, name: str, device: torch.device) -> torch.Tensor:
    """``idx`` as contiguous int32 on ``device``.  Indices on the host are
    checked against the pool here and raise when out of range; indices
    already on the card are not read back, which would stall the stream:
    the kernel skips a descriptor whose page lies outside the pools."""
    idx = torch.as_tensor(idx)
    if idx.device.type == "cpu" and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_pages:
            raise IndexError(f"batch_copy: {name} holds pages in [{lo}, {hi}], "
                             f"the pool has {n_pages}")
    return idx.to(device=device, dtype=torch.int32).contiguous()


def batch_copy(src_pool: torch.Tensor, dst_pool: torch.Tensor,
               src_idx: torch.Tensor, dst_idx: torch.Tensor) -> torch.Tensor:
    """Batch-descriptor page copy: dst_pool[dst_idx[i]] = src_pool[src_idx[i]].

    Pools are [n_pages, ...page_shape...] of any dtype; pages are bit-cast
    to uint32 words.  ``dst_pool`` (contiguous) is written IN PLACE and
    returned: the counterpart of the JAX package donating it, so pages the
    batch does not touch keep their contents.  Duplicate destinations
    resolve last-writer-wins.  If the pools share storage, the source is
    cloned first so that reads see it as it was before the call."""
    if src_pool.dtype != dst_pool.dtype or src_pool.shape[1:] != dst_pool.shape[1:]:
        raise ValueError(f"batch_copy: pools disagree: {tuple(src_pool.shape)} "
                         f"{src_pool.dtype} vs {tuple(dst_pool.shape)} {dst_pool.dtype}")
    if src_pool.device != dst_pool.device:
        raise ValueError(f"batch_copy: pools on {src_pool.device} and {dst_pool.device}")
    if not dst_pool.is_contiguous():
        raise ValueError("batch_copy: dst_pool is written in place and must be contiguous")
    P, Q = src_pool.shape[0], dst_pool.shape[0]
    page_bytes = math.prod(dst_pool.shape[1:]) * dst_pool.element_size()
    if page_bytes % 4:
        raise ValueError(f"batch_copy: pages must be 4-byte multiples, got {page_bytes}")
    page_words = page_bytes // 4
    if src_pool.untyped_storage().data_ptr() == dst_pool.untyped_storage().data_ptr():
        src_pool = src_pool.clone()
    sw = _bitcast_to_u32(src_pool).view(P, page_words)
    dw = dst_pool.reshape(-1).view(torch.uint32).view(Q, page_words)
    si = _page_index(src_idx, P, "src_idx", dst_pool.device)
    di = _page_index(dst_idx, Q, "dst_idx", dst_pool.device)
    _bc.batch_copy_pages(sw, dw, si, di)
    return dst_pool
