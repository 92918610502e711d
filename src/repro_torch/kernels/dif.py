"""Data Integrity Field (DIF) operations (paper Table 1, "Move").

DSA checks, inserts or strips an 8-byte DIF on every 512- or 4096-byte
block while moving data.  As in the JAX package (repro/kernels/dif.py),
blocks are the rows of a [n_blocks, block_words] word grid, every block is
one chunk of the ported CRC kernel (``crc32_chunk_states`` with
C = n_blocks), and the framing [n_blocks, block_words + 2] = data, CRC,
``ref_tag << 16 | block# & 0xFFFF`` is torch glue.  No kernel of its own:
on CUDA tensors the CRC kernel launches once per insert or check.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import crc32 as _crc
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ref import int32_bits


def _block_crcs(blocks: torch.Tensor) -> torch.Tensor:
    """blocks [n_blocks, block_words] uint32 (contiguous) -> per-block CRC32
    [n_blocks] uint32."""
    return _crc.crc32_chunk_states(blocks, _ops._tables(blocks.device))


def dif_insert(words: torch.Tensor, *, block_words: int = 128, ref_tag: int = 0) -> torch.Tensor:
    """[n_blocks * block_words] words -> framed [n_blocks, block_words + 2]
    uint32."""
    blocks = _ops._bitcast_to_u32(words).view(-1, block_words)
    n = blocks.shape[0]
    crcs = _block_crcs(blocks)
    framed = torch.empty(n, block_words + 2, dtype=torch.int32, device=blocks.device)
    framed[:, :block_words] = blocks.view(torch.int32)
    framed[:, block_words] = crcs.view(torch.int32)
    framed[:, block_words + 1] = (torch.arange(n, dtype=torch.int32, device=blocks.device)
                                  .bitwise_and_(0xFFFF) | int32_bits(ref_tag << 16))
    return framed.view(torch.uint32)


def dif_check(framed: torch.Tensor, *, block_words: int = 128) -> torch.Tensor:
    """framed [n_blocks, block_words + 2] -> per-block ok mask [n_blocks]
    bool.  The data columns are copied out first (one extra pass over the
    data): the CRC kernel takes contiguous chunks."""
    f = framed.view(torch.int32)
    crcs = _block_crcs(f[:, :block_words].contiguous().view(torch.uint32))
    return crcs.view(torch.int32) == f[:, block_words]


def dif_strip(framed: torch.Tensor, *, block_words: int = 128) -> torch.Tensor:
    return framed.view(torch.int32)[:, :block_words].reshape(-1).view(torch.uint32)


def dif_update(framed: torch.Tensor, *, block_words: int = 128, ref_tag: int = 0) -> torch.Tensor:
    """Recompute tags over (possibly modified) framed data."""
    return dif_insert(dif_strip(framed, block_words=block_words),
                      block_words=block_words, ref_tag=ref_tag)
