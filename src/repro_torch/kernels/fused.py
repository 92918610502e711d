"""Fused memcpy + CRC32 in ONE launch (the checkpoint copy-then-checksum pair).

The paper's per-descriptor cost model (Fig. 2/3) says small-op throughput is
launch-bound, and two descriptors that always travel together pay two
launches and stream the data twice.  ``copy_crc_words`` copies every chunk
to the destination AND folds it into the chunk CRC states in one read pass.
On a CUDA tensor it launches ``crc_chunks_kernel<true>``
(csrc/dsa_kernels.cu), which replaces the JAX package's Pallas
``copy_crc_words`` (repro/kernels/fused.py:56).  The fused fill+verify pair
of that module is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.crc32 import _check_tables, crc32_chunk_states_plain


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
    C, W = data.shape
    states = torch.empty(C, dtype=torch.uint32, device=data.device)
    dst = torch.empty_like(data)
    if C:
        _build.launch("dsa_copy_crc_words", data.data_ptr(), tables.data_ptr(),
                      states.data_ptr(), dst.data_ptr(), C, W, _build.stream(data))
        _build.count(copy_crc_words)
    return states, dst


copy_crc_words.launches = 0
