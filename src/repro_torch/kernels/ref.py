"""CRC table machinery (numpy) and plain oracles for the ported ops.

These define the SEMANTICS; the kernels and their plain versions must match
them bit-exactly.  Buffers are modeled as uint32 words (the paper's DSA
operates on bytes; the 4-byte granule is the JAX package's choice, kept so
results compare word for word).  CRC32 matches zlib.crc32 over the
little-endian byte view.
"""
from __future__ import annotations

import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------- CRC32 tables
_POLY = 0xEDB88320  # reflected IEEE


def _make_crc_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (np.uint64(_POLY) * (c & np.uint64(1)))
        tab[i] = c
    return tab.astype(np.uint32)


def make_crc_tables(n: int = 4) -> np.ndarray:
    """Slice-by-n tables [n, 256] uint32 (T0 = classic byte table)."""
    t0 = _make_crc_table()
    tabs = [t0]
    for _ in range(n - 1):
        prev = tabs[-1]
        nxt = (t0[prev & 0xFF] ^ (prev >> np.uint32(8))).astype(np.uint32)
        tabs.append(nxt)
    return np.stack(tabs)  # [n, 256]


# GF(2) combine machinery (zlib crc32_combine) -------------------------------
def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= int(mat[i])
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(m)) for m in mat], dtype=np.uint64)


def crc32_shift_matrix(length_bytes: int) -> np.ndarray:
    """Matrix advancing a CRC state over ``length_bytes`` zero bytes: [32]
    u32 columns (column i = image of bit i)."""
    ident = np.array([1 << i for i in range(32)], dtype=np.uint64)
    if length_bytes == 0:
        return ident.astype(np.uint32)
    # operator for one zero BIT, squared three times: one zero BYTE
    op = np.zeros(32, dtype=np.uint64)
    op[0] = np.uint64(_POLY)
    for i in range(1, 32):
        op[i] = np.uint64(1) << np.uint64(i - 1)
    for _ in range(3):
        op = _gf2_matrix_square(op)
    # binary exponentiation over bytes
    result = ident.copy()
    base = op
    n = length_bytes
    while n:
        if n & 1:
            result = np.array([_gf2_matrix_times(base, int(r)) for r in result],
                              dtype=np.uint64)
        base = _gf2_matrix_square(base)
        n >>= 1
    return result.astype(np.uint32)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    if len2 == 0:
        return crc1
    mat = crc32_shift_matrix(len2)
    return _gf2_matrix_times(mat.astype(np.uint64), crc1) ^ crc2


# --------------------------------------------------------------------------- oracles
def memcpy_ref(src: torch.Tensor) -> torch.Tensor:
    return src.clone()  # identity copy


def crc32_ref(x: torch.Tensor) -> int:
    """zlib.crc32 of the little-endian byte view (ground truth), read on
    the host without a second copy."""
    host = x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return zlib.crc32(memoryview(host)) & 0xFFFFFFFF


def batch_copy_ref(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                   src_idx: torch.Tensor, dst_idx: torch.Tensor) -> torch.Tensor:
    """Copy pages src_pool[src_idx[i]] -> dst_pool[dst_idx[i]] one descriptor
    after another (later descriptors win on collision, matching sequential
    DSA semantics); returns a new pool."""
    out = dst_pool.clone()
    for s, d in zip(src_idx.tolist(), dst_idx.tolist()):
        out[d].copy_(src_pool[s])
    return out


# --------------------------------------------------------------------------- fill, compare, dualcast, delta, DIF
def _i32(x: torch.Tensor) -> torch.Tensor:
    """The same bits as int32: PyTorch on the CPU has no ``<``, ``scatter``
    or ``index_put`` for uint32."""
    return x.contiguous().reshape(-1).view(torch.int32)


def int32_bits(w: int) -> int:
    """The int32 value with the bits of the 32-bit word ``w`` (int32 views
    carry uint32 words through ops the CPU lacks for uint32)."""
    w &= 0xFFFFFFFF
    return w - (1 << 32) if w & 0x80000000 else w


def fill_ref(shape: Tuple[int, ...], pattern_words: Sequence[int],
             device="cpu") -> torch.Tensor:
    """A uint32 word buffer of ``shape`` on ``device`` holding the pattern
    repeated (2 or 4 words: the paper's 8/16-byte patterns).  Also the plain
    version of ``fill.fill_words``."""
    n = 1
    for d in shape:
        n *= d
    pat = torch.tensor([int32_bits(int(w)) for w in pattern_words], dtype=torch.int32,
                       device=device)
    reps = -(-n // pat.numel())
    return pat.repeat(reps)[:n].view(torch.uint32).reshape(shape)


def compare_ref(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first differing word index or -1) over the word views, as a
    0-d bool and a 0-d int32 on ``a``'s device (``argmax`` of a bool mask is
    its first True, so nothing is read back to the host).  Also the plain
    version of ``compare.compare_words``."""
    diff = _i32(a) != _i32(b)
    if diff.numel() == 0:
        return (torch.ones((), dtype=torch.bool, device=a.device),
                torch.full((), -1, dtype=torch.int32, device=a.device))
    any_diff = diff.any()
    first = torch.argmax(diff.to(torch.uint8)).to(torch.int32)
    return ~any_diff, torch.where(any_diff, first, torch.full_like(first, -1))


def compare_pattern_ref(a: torch.Tensor, pattern_words: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first word index or -1) of ``a``'s word view against the
    pattern repeated over it (word i against ``pattern_words[i % p]``), as
    ``compare_ref`` returns it.  Also the plain version of
    ``compare.compare_pattern_words``."""
    expect = fill_ref((_i32(a).numel(),), pattern_words, device=a.device)
    return compare_ref(a, expect)


def dualcast_ref(src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two copies of ``src``.  Also the plain version of
    ``dualcast.dualcast_words``."""
    return src.clone(), src.clone()


def delta_create_ref(src: torch.Tensor, ref: torch.Tensor, cap: int):
    """Delta record of ``src`` against ``ref``, 1-word granules, on
    ``src``'s device: (offsets [cap] int32 ascending with -1 pads, data [cap]
    uint32 with 0 pads, the true count (0-d int32, may exceed cap), overflow
    = count > cap).  Also the plain version of
    ``delta_create.delta_record_words``."""
    s, r = _i32(src), _i32(ref)
    idx = torch.nonzero(s != r).reshape(-1)
    count = idx.numel()
    k = min(count, cap)
    offsets = torch.full((cap,), -1, dtype=torch.int32, device=src.device)
    data = torch.zeros(cap, dtype=torch.int32, device=src.device)
    offsets[:k] = idx[:k].to(torch.int32)
    data[:k] = s[idx[:k]]
    return (offsets, data.view(torch.uint32),
            torch.tensor(count, dtype=torch.int32, device=src.device),
            torch.tensor(count > cap, device=src.device))


def delta_apply_ref(ref: torch.Tensor, offsets: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A copy of ``ref`` with the record applied entry by entry, skipping
    ``off < 0`` (pads) and ``off >= n_words``, the last writer winning: the
    semantics of the Pallas kernel's serial walk (repro/kernels/delta_apply.py).

    The JAX package's own oracle (``repro.kernels.ref.delta_apply_ref``) and
    its ``use_kernel=False`` path differ on one point: they clip the -1 pads
    to offset 0 and write the old word 0 back there, and since the pads come
    after the real entries, a change at word 0 is undone.  This oracle keeps
    such a change."""
    out = _i32(ref).clone()
    n = out.numel()
    off = offsets.reshape(-1).to(torch.int64).cpu()
    vals = _i32(data).cpu()
    valid = (off >= 0) & (off < n)
    order = torch.arange(off.numel())
    # the last entry naming each word: scatter the entry order with amax
    last = torch.full((n,), -1, dtype=torch.int64).scatter_reduce(
        0, off[valid], order[valid], "amax")
    hit = last >= 0
    out[hit.to(out.device)] = vals[last[hit]].to(out.device)
    return out.view(ref.dtype).reshape(ref.shape)


def dif_insert_ref(words: torch.Tensor, block_words: int = 128, ref_tag: int = 0) -> torch.Tensor:
    """Append an 8-byte DIF (2 words: crc32, ref_tag << 16 | block#) to each
    data block of ``block_words`` words.  Output [n_blocks, block_words+2]."""
    w = _i32(words).cpu().numpy().view(np.uint32).reshape(-1, block_words)
    out = np.zeros((w.shape[0], block_words + 2), dtype=np.uint32)
    out[:, :block_words] = w
    for i in range(w.shape[0]):
        out[i, block_words] = zlib.crc32(w[i].astype("<u4").tobytes()) & 0xFFFFFFFF
        out[i, block_words + 1] = ((ref_tag << 16) | (i & 0xFFFF)) & 0xFFFFFFFF
    return torch.from_numpy(out.view(np.int32)).view(torch.uint32)


def dif_check_ref(framed: torch.Tensor, block_words: int = 128) -> torch.Tensor:
    f = _i32(framed).cpu().numpy().view(np.uint32).reshape(-1, block_words + 2)
    return torch.tensor([zlib.crc32(row[:block_words].astype("<u4").tobytes()) & 0xFFFFFFFF
                         == int(row[block_words]) for row in f], dtype=torch.bool)


def dif_strip_ref(framed: torch.Tensor, block_words: int = 128) -> torch.Tensor:
    return framed.reshape(-1, block_words + 2)[:, :block_words].reshape(-1).clone()
