"""Create Delta Record kernel (paper Table 1, "Compare").

The DSA emits (offset, data) pairs for the granules where a buffer differs
from a reference, into a record of fixed capacity, with an overflow status
when more differ than fit.  ``delta_record_words`` builds that record over
1-word granules: (offsets [cap] int32 ascending with -1 pads, data [cap]
uint32 with 0 pads, the true count as a 0-d int32 even above cap, overflow
= count > cap as a 0-d bool), the first ``cap`` differing words when more
differ, as ``jnp.nonzero(size=cap)`` keeps them.

On CUDA tensors it launches ``delta_count_kernel`` and
``delta_write_kernel`` (csrc/dsa_kernels.cu), which replace the JAX
package's Pallas ``delta_mask_words`` (repro/kernels/delta_create.py:25)
together with the jnp compaction of ``ops.delta_create``: the compaction
runs on the card, and nothing is read back to the host, so a PE worker
never blocks its stream.  The only glue is one ``torch.cumsum`` of the
per-tile counts.  On CPU tensors it runs the plain version.

The scratch tensors (the byte masks, the tile counts and their scan) are
freed when the wrapper returns, before the kernels have run: the caching
allocator hands their memory only to work queued later on the same
stream, which runs after the kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import delta_create_ref

#: words of one CTA tile in the two kernels (kDeltaTileGroups * 4)
TILE_WORDS = 4096
#: offsets are int32, as in the reference
MAX_WORDS = 2**31 - 1

Record = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


#: plain PyTorch version: ``nonzero`` of the word views' mismatch mask, cut
#: to ``cap`` and padded
delta_record_words_plain = delta_create_ref


def delta_record_words(src: torch.Tensor, ref: torch.Tensor, cap: int) -> Record:
    """The delta record of ``src`` against ``ref`` ([n] uint32, contiguous,
    on one device) with capacity ``cap`` entries."""
    _build.check(src, "delta_record_words src", torch.uint32, 1)
    _build.check(ref, "delta_record_words ref", torch.uint32, 1)
    _build.same_device("delta_record_words", src, ref)
    if src.shape != ref.shape:
        raise ValueError(f"delta_record_words: src {tuple(src.shape)} vs ref "
                         f"{tuple(ref.shape)} words")
    if src.numel() > MAX_WORDS:
        raise ValueError(f"delta_record_words: {src.numel()} words exceed int32 offsets")
    if cap < 0:
        raise ValueError(f"delta_record_words: cap must be >= 0, got {cap}")
    if src.device.type == "cpu":
        return delta_record_words_plain(src, ref, cap)
    dev, n = src.device, src.numel()
    n_tiles = -(-n // TILE_WORDS)
    mask = torch.empty(-(-n // 4), dtype=torch.uint8, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty(cap, dtype=torch.int32, device=dev)
    data = torch.empty(cap, dtype=torch.uint32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    stream = _build.stream(src)
    _build.launch("dsa_delta_count", src.data_ptr(), ref.data_ptr(), n, mask.data_ptr(),
                  counts.data_ptr(), n_tiles, stream)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    _build.launch("dsa_delta_write", src.data_ptr(), n, mask.data_ptr(), counts.data_ptr(),
                  incl.data_ptr(), n_tiles, cap, offsets.data_ptr(), data.data_ptr(),
                  count.data_ptr(), overflow.data_ptr(), stream)
    _build.count(delta_record_words)
    return offsets, data, count, overflow


delta_record_words.launches = 0
