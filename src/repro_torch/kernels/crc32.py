"""CRC Generation kernel (paper Table 1, CRC32).

CRC is bit-serial by definition; the DSA computes it in streaming hardware.
The port keeps the JAX package's chunked scheme, which exploits CRC's GF(2)
linearity:

  1. split the buffer into C contiguous chunks of W words,
  2. compute the C chunk CRCs in parallel, one slice-by-4 step per word
     against [4, 256] tables (``crc32_chunk_states``: the CUDA kernel
     ``crc_chunks_kernel`` replaces the Pallas ``crc32_chunk_states`` of
     repro/kernels/crc32.py:58),
  3. fold the C chunk CRCs with the zlib crc32_combine shift matrix, a
     32x32 GF(2) operator (``combine_chunk_crcs``: the CUDA kernel
     ``gf2_fold_kernel`` replaces the jnp fold of repro/kernels/crc32.py:97).

Matches zlib.crc32 bit-exactly.  The plain versions carry CRC state as
int64 masked to 32 bits: PyTorch has no shift for uint32 on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

INIT = 0xFFFFFFFF
_M8 = 0xFF


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 values in [0, 2**32)."""
    return t.view(torch.int32).to(torch.int64) & INIT


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> uint32 words (same bits)."""
    return t.to(torch.int32).view(torch.uint32)


def _crc_step(st: torch.Tensor, word: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """One slice-by-4 step over a vector of chunk states (int64 [C])."""
    x = st ^ word
    return (tabs[3][x & _M8] ^ tabs[2][(x >> 8) & _M8]
            ^ tabs[1][(x >> 16) & _M8] ^ tabs[0][(x >> 24) & _M8])


def crc32_chunk_states_plain(data: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the W steps run as a Python loop over the
    chunk axis."""
    C, W = data.shape
    words = u32_to_i64(data)
    tabs = u32_to_i64(tables)
    st = torch.full((C,), INIT, dtype=torch.int64, device=data.device)
    for w in range(W):
        st = _crc_step(st, words[:, w], tabs)
    return i64_to_u32(st ^ INIT)


def crc32_chunk_states(data: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-chunk CRC states [C] uint32 (after the final xor) of ``data``
    [C, W] uint32 with the slice-by-4 ``tables`` [4, 256] uint32."""
    _build.check(data, "crc32_chunk_states data", torch.uint32, 2)
    _check_tables(tables)
    _build.same_device("crc32_chunk_states", data, tables)
    if data.device.type == "cpu":
        return crc32_chunk_states_plain(data, tables)
    C, W = data.shape
    states = torch.empty(C, dtype=torch.uint32, device=data.device)
    if C:
        _build.launch("dsa_crc32_chunk_states", data.data_ptr(), tables.data_ptr(),
                      states.data_ptr(), C, W, _build.stream(data))
        _build.count(crc32_chunk_states)
    return states


crc32_chunk_states.launches = 0


def _check_tables(tables: torch.Tensor) -> None:
    _build.check(tables, "crc32 tables", torch.uint32, 2)
    if tuple(tables.shape) != (4, 256):
        raise ValueError(f"crc32 tables must be [4, 256], got {tuple(tables.shape)}")


# ------------------------------------------------------------------ combine
def gf2_apply(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """mat int64 [32] columns; vec int64 scalar -> int64 scalar (the
    xor-reduction is five halving folds: PyTorch has no xor reduce)."""
    bits = (vec >> torch.arange(32, device=mat.device)) & 1
    v = torch.where(bits.bool(), mat, torch.zeros_like(mat))
    while v.numel() > 1:
        half = v.numel() // 2
        v = v[:half] ^ v[half:]
    return v[0]


def combine_chunk_crcs_plain(states: torch.Tensor, shift_mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fold left to right, crc = shift(crc) ^ next."""
    s = u32_to_i64(states)
    mat = u32_to_i64(shift_mat)
    crc = s[0]
    for i in range(1, s.shape[0]):
        crc = gf2_apply(mat, crc) ^ s[i]
    return i64_to_u32(crc.reshape(1))[0]


def combine_chunk_crcs(states: torch.Tensor, shift_mat: torch.Tensor) -> torch.Tensor:
    """Fold per-chunk CRCs ``states`` [C] uint32 (equal chunk lengths) with
    the [32] uint32 shift matrix of one chunk; returns a 0-d uint32."""
    _build.check(states, "combine_chunk_crcs states", torch.uint32, 1)
    _build.check(shift_mat, "combine_chunk_crcs shift_mat", torch.uint32, 1)
    _build.same_device("combine_chunk_crcs", states, shift_mat)
    if shift_mat.shape[0] != 32 or states.shape[0] < 1:
        raise ValueError(f"combine_chunk_crcs: need [32] shift matrix and >= 1 "
                         f"state, got {tuple(shift_mat.shape)} and "
                         f"{tuple(states.shape)}")
    if states.device.type == "cpu":
        return combine_chunk_crcs_plain(states, shift_mat)
    out = torch.empty(1, dtype=torch.uint32, device=states.device)
    _build.launch("dsa_gf2_fold", states.data_ptr(), shift_mat.data_ptr(),
                  out.data_ptr(), states.shape[0], _build.stream(states))
    _build.count(combine_chunk_crcs)
    return out[0]


combine_chunk_crcs.launches = 0
