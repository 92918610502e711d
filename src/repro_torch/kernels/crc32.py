"""CRC Generation kernel (paper Table 1, CRC32).

CRC is bit-serial by definition; the DSA computes it in streaming hardware.
The port keeps the JAX package's chunked scheme, which exploits CRC's GF(2)
linearity, and splits each chunk once more for the card:

  1. split the buffer into C contiguous chunks of W words (the JAX
     package's choice, so the chunk states match it),
  2. split each chunk into S sub-chunks (``subchunk_plan``): a first one of
     h <= ``SUB_WORDS`` words, then S - 1 of ``SUB_WORDS`` words each, so a
     chunk runs as many short chains and not as one long one,
  3. compute every sub-chunk's zlib CRC in parallel, one slice-by-4 step
     per word against [4, 256] tables (the CUDA kernel ``crc_chunks_kernel``
     replaces the Pallas ``crc32_chunk_states`` of repro/kernels/crc32.py:58),
  4. fold each chunk's S sub-chunk CRCs into its state, and the C chunk
     states into the buffer's CRC, with zlib's crc32_combine shift matrix, a
     32x32 GF(2) operator (``fold_crcs``: the CUDA kernel ``crc_fold_kernel``
     replaces the jnp fold of repro/kernels/crc32.py:97).

Matches zlib.crc32 bit-exactly.  The plain versions carry CRC state as
int64 masked to 32 bits: PyTorch has no shift for uint32 on the CPU.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import _build

INIT = 0xFFFFFFFF
_M8 = 0xFF
#: words of every sub-chunk but a chunk's first (csrc/dsa_kernels.cu
#: kSubWords): 512 bytes, a chain of 128 dependent steps (of the two
#: lengths timed on the card, 128 and 256, the faster: PERF.md)
SUB_WORDS = 128
#: lanes of the fold's warp: a group's CRCs split into this many ranges
FOLD_LANES = 32


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 values in [0, 2**32)."""
    return t.view(torch.int32).to(torch.int64) & INIT


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> uint32 words (same bits)."""
    return t.to(torch.int32).view(torch.uint32)


def subchunk_plan(W: int) -> Tuple[int, int]:
    """(S, h): a chunk of W words runs as S sub-chunks, words [0, h) and
    then S - 1 of ``SUB_WORDS`` words each.  Only the first may be short, so
    every CRC a fold appends covers a whole ``SUB_WORDS`` unit; W <= SUB_WORDS
    gives S = 1 (the chunk whole)."""
    S = max(1, -(-W // SUB_WORDS))
    return S, W - (S - 1) * SUB_WORDS


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


def crc32_chunk_states_split_plain(data: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The kernels' split on the CPU: the sub-chunk CRCs of ``data`` [C, W]
    (the [C, h] heads and the [C * (S - 1), SUB_WORDS] rest), folded by
    ``fold_crcs_plain``.  Equal to ``crc32_chunk_states_plain``."""
    from repro_torch.kernels import ops  # ops imports this module

    C, W = data.shape
    S, h = subchunk_plan(W)
    if S == 1:
        return crc32_chunk_states_plain(data, tables)
    head = crc32_chunk_states_plain(data[:, :h], tables)
    rest = crc32_chunk_states_plain(data[:, h:].reshape(C * (S - 1), SUB_WORDS), tables)
    crcs = torch.cat([head.view(C, 1), rest.view(C, S - 1)], dim=1)
    return fold_crcs_plain(crcs, ops._shift_mat(4 * SUB_WORDS, data.device), C, S)


def _launch_chunk_crcs(entry: str, wrapper, data: torch.Tensor, tables: torch.Tensor,
                       *dst: torch.Tensor) -> torch.Tensor:
    """The CRC pair on the card: ``entry`` writes the [C, S] sub-chunk CRCs
    of ``data`` [C, W], and ``fold_crcs`` turns them into the [C] chunk
    states, which it returns (where S = 1 the CRCs are the states)."""
    C, W = data.shape
    S, _ = subchunk_plan(W)
    crcs = torch.empty(C, S, dtype=torch.uint32, device=data.device)
    if not C:
        return crcs.view(C)
    _build.launch(entry, data.data_ptr(), tables.data_ptr(), crcs.data_ptr(),
                  *(d.data_ptr() for d in dst), C, W, _build.stream(data))
    _build.count(wrapper)
    if S == 1:
        return crcs.view(C)
    from repro_torch.kernels import ops  # ops imports this module

    mat = ops._shift_mat(4 * SUB_WORDS, data.device)
    # the LRU may evict (free) the matrix while this stream still reads it
    mat.record_stream(torch.cuda.current_stream(data.device))
    return fold_crcs(crcs, mat)


def crc32_chunk_states(data: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-chunk CRC states [C] uint32 (after the final xor) of ``data``
    [C, W] uint32 with the slice-by-4 ``tables`` [4, 256] uint32.  On the
    card: one launch where W <= SUB_WORDS, else the sub-chunk CRCs and their
    fold."""
    _build.check(data, "crc32_chunk_states data", torch.uint32, 2)
    _check_tables(tables)
    _build.same_device("crc32_chunk_states", data, tables)
    if data.device.type == "cpu":
        return crc32_chunk_states_plain(data, tables)
    return _launch_chunk_crcs("dsa_crc32_chunk_states", crc32_chunk_states, data, tables)


crc32_chunk_states.launches = 0


def _check_tables(tables: torch.Tensor) -> None:
    _build.check(tables, "crc32 tables", torch.uint32, 2)
    if tuple(tables.shape) != (4, 256):
        raise ValueError(f"crc32 tables must be [4, 256], got {tuple(tables.shape)}")


# ------------------------------------------------------------------ fold
def gf2_apply(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """mat int64 [32] columns; vec int64 of any shape -> mat times each of
    its elements, in that shape (the xor-reduction is five halving folds:
    PyTorch has no xor reduce)."""
    bits = (vec.unsqueeze(-1) >> torch.arange(32, device=mat.device)) & 1
    v = torch.where(bits.bool(), mat, torch.zeros_like(mat))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] ^ v[..., half:]
    return v[..., 0]


def lane_ranges(S: int) -> Tuple[List[int], List[int]]:
    """(starts, counts) of the fold's 32 lanes over S units: contiguous
    ranges from left to right, as even as they go, lane 0's holding unit 0
    (so a lane with nothing, where S < 32, lies right of every unit)."""
    q, r = divmod(S, FOLD_LANES)
    counts = [q + (j < r) for j in range(FOLD_LANES)]
    starts = [j * q + min(j, r) for j in range(FOLD_LANES)]
    return starts, counts


def fold_crcs_plain(crcs: torch.Tensor, base_mat: torch.Tensor, G: int, S: int) -> torch.Tensor:
    """Plain PyTorch version of ``crc_fold_kernel``, step by step: the CRC
    of each of G groups of S finished CRCs ``crcs``, every unit but a
    group's first of the length that ``base_mat`` [32] advances over.
    Returns [G] uint32.

    1. the powers base^(2^i) for i < bit length of S, by squaring;
    2. 32 contiguous lane ranges (``lane_ranges``);
    3. each lane folds its range serially, acc = base acc ^ crc, from 0
       (zlib's CRC of no bytes);
    4. a 5-level tree joins lane pairs left to right: the left acc times
       base^count_right (one product per set bit), xor the right acc, and
       the counts add."""
    x = u32_to_i64(crcs.reshape(G, S))
    base = u32_to_i64(base_mat)
    powers = [base]
    for _ in range(1, S.bit_length()):  # column b of P^2 is P times column b of P
        powers.append(gf2_apply(powers[-1], powers[-1]))
    starts, counts = lane_ranges(S)
    start_t = torch.tensor(starts, device=x.device)
    count_t = torch.tensor(counts, device=x.device)
    acc = torch.zeros(G, FOLD_LANES, dtype=torch.int64, device=x.device)
    for k in range(max(counts)):  # the lanes side by side on the last axis
        unit = x[:, (start_t + k).clamp(max=S - 1)]
        acc = torch.where(count_t > k, gf2_apply(base, acc) ^ unit, acc)
    d = 1
    while d < FOLD_LANES:
        for left in range(0, FOLD_LANES, 2 * d):
            right = left + d
            a = acc[:, left]
            for i in range(counts[right].bit_length()):
                if counts[right] >> i & 1:
                    a = gf2_apply(powers[i], a)
            acc[:, left] = a ^ acc[:, right]
            counts[left] += counts[right]
        d *= 2
    return i64_to_u32(acc[:, 0])


def fold_crcs(crcs: torch.Tensor, base_mat: torch.Tensor) -> torch.Tensor:
    """The CRC [G] uint32 of each row of ``crcs`` [G, S] uint32 (finished
    CRCs, every one but a row's first of the length the [32] uint32
    ``base_mat`` advances over).  On the card ``crc_fold_kernel``, one warp
    a row; it serves ``combine_chunk_crcs`` and the sub-chunk fold of the
    CRC pair."""
    _build.check(crcs, "fold_crcs crcs", torch.uint32, 2)
    _build.check(base_mat, "fold_crcs base_mat", torch.uint32, 1)
    _build.same_device("fold_crcs", crcs, base_mat)
    G, S = crcs.shape
    if base_mat.shape[0] != 32 or S < 1:
        raise ValueError(f"fold_crcs: need a [32] matrix and >= 1 CRC a row, got "
                         f"{tuple(base_mat.shape)} and {tuple(crcs.shape)}")
    if crcs.device.type == "cpu":
        return fold_crcs_plain(crcs, base_mat, G, S)
    out = torch.empty(G, dtype=torch.uint32, device=crcs.device)
    if G:
        _build.launch("dsa_crc_fold", crcs.data_ptr(), base_mat.data_ptr(), out.data_ptr(),
                      G, S, _build.stream(crcs))
        _build.count(fold_crcs)
    return out


fold_crcs.launches = 0


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
    the [32] uint32 shift matrix of one chunk; returns a 0-d uint32.  On the
    card ``fold_crcs`` with one row of C units."""
    _build.check(states, "combine_chunk_crcs states", torch.uint32, 1)
    _build.check(shift_mat, "combine_chunk_crcs shift_mat", torch.uint32, 1)
    _build.same_device("combine_chunk_crcs", states, shift_mat)
    if shift_mat.shape[0] != 32 or states.shape[0] < 1:
        raise ValueError(f"combine_chunk_crcs: need [32] shift matrix and >= 1 "
                         f"state, got {tuple(shift_mat.shape)} and "
                         f"{tuple(states.shape)}")
    if states.device.type == "cpu":
        return combine_chunk_crcs_plain(states, shift_mat)
    return fold_crcs(states.view(1, -1), shift_mat)[0]
