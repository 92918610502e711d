"""CRC table machinery (numpy) and plain oracles for the ported ops.

These define the SEMANTICS; the kernels and their plain versions must match
them bit-exactly.  Buffers are modeled as uint32 words (the paper's DSA
operates on bytes; the 4-byte granule is the JAX package's choice, kept so
results compare word for word).  CRC32 matches zlib.crc32 over the
little-endian byte view.
"""
from __future__ import annotations

import zlib

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
