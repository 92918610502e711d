"""Fused streaming kernels: the hot-path op pairs in ONE launch.

The paper's per-descriptor cost model (Fig. 2/3) says small-op throughput is
launch-bound, and two descriptors that always travel together pay two
launches and stream the data twice.

  copy_crc_words     memcpy + CRC32: every chunk is copied to the
                     destination AND folded into the chunk CRC states in one
                     read pass.  On a CUDA tensor it launches
                     ``crc_chunks_kernel<true>`` (csrc/dsa_kernels.cu) over
                     the sub-chunks of crc32.py, and their fold where a
                     chunk has more than one; it replaces the JAX package's
                     Pallas ``copy_crc_words`` (repro/kernels/fused.py:56).
  fill_verify_words  fill + compare_pattern: the pattern is stored and read
                     back from memory for the (equal?, first | -1) pair, in
                     one launch.  On CUDA it launches ``fill_verify_kernel``,
                     which replaces ``fill_verify_words``
                     (repro/kernels/fused.py:106) and the jnp reduction of
                     its per-block records in ``ops.fill_verify``.

On CPU tensors both run their plain versions, the unfused pairs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compare import MAX_WORDS, compare_pattern_words_plain
from repro_torch.kernels.crc32 import (_check_tables, _launch_chunk_crcs,
                                       crc32_chunk_states_plain)
from repro_torch.kernels.fill import fill_words_plain, pattern_quad, pattern_words


def copy_crc_words_plain(data: torch.Tensor,
                         tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the unfused pair."""
    return crc32_chunk_states_plain(data, tables), data.clone()


def copy_crc_words(data: torch.Tensor,
                   tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (per-chunk CRC states [C] uint32 after the final xor, a copy
    [C, W] uint32 of ``data``)."""
    _build.check(data, "copy_crc_words data", torch.uint32, 2)
    _check_tables(tables)
    _build.same_device("copy_crc_words", data, tables)
    if data.device.type == "cpu":
        return copy_crc_words_plain(data, tables)
    dst = torch.empty_like(data)
    return _launch_chunk_crcs("dsa_copy_crc_words", copy_crc_words, data, tables, dst), dst


copy_crc_words.launches = 0


def fill_verify_words_plain(n_words: int, pattern,
                            device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the unfused pair, a fill and a compare of the
    filled buffer against the pattern."""
    filled = fill_words_plain(n_words, pattern, device=device)
    return (filled, *compare_pattern_words_plain(filled, pattern))


def fill_verify_words(n_words: int, pattern,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A new [n_words] uint32 buffer on ``device`` filled with the repeating
    1-, 2- or 4-word ``pattern``, and the verify pair read back from it:
    (filled, equal? (0-d bool), first bad word | -1 (0-d int32)), the pair on
    the card."""
    pat = pattern_words(pattern)
    if not 0 <= n_words <= MAX_WORDS:
        raise ValueError(f"fill_verify_words: n_words must be in [0, {MAX_WORDS}], "
                         f"got {n_words}")
    device = torch.device(device)
    if device.type == "cpu":
        return fill_verify_words_plain(n_words, pat, device=device)
    if device.type != "cuda":
        raise ValueError(f"fill_verify_words: device {device} is not supported; the "
                         f"kernel runs on CUDA, the plain version on the CPU")
    dst = torch.empty(n_words, dtype=torch.uint32, device=device)
    state = torch.empty(2, dtype=torch.int32, device=device)
    equal = torch.empty((), dtype=torch.bool, device=device)
    first = torch.empty((), dtype=torch.int32, device=device)
    _build.launch("dsa_fill_verify_words", dst.data_ptr(), n_words,
                  *pattern_quad(pat), state.data_ptr(), equal.data_ptr(),
                  first.data_ptr(), _build.stream(dst))
    _build.count(fill_verify_words)
    return dst, equal, first


fill_verify_words.launches = 0
