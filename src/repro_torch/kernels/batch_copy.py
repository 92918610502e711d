"""Batch-descriptor page copy kernel (paper F2, the key DSA feature).

A batch descriptor delivers an array of work descriptors processed in one
submission.  ``batch_copy_pages`` copies N pages
``dst_pool[dst_idx[i]] = src_pool[src_idx[i]]`` in ONE launch of
``batch_copy_pages_kernel`` (csrc/dsa_kernels.cu), which replaces the JAX
package's Pallas ``batch_copy_pages`` (repro/kernels/batch_copy.py:30).  This
amortises one launch over N page copies as DSA amortises one ENQCMD over N
descriptors: it moves paged-KV-cache blocks and checkpoint pages.

The JAX package donates the destination pool, so pages the batch does not
touch keep their contents.  The counterpart here is an in-place write:
``dst_pool`` is updated and returned.  Descriptors that name the same
destination page resolve last-writer-wins, as the Pallas grid's in-order steps
did.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def batch_copy_pages_plain(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                           src_idx: torch.Tensor,
                           dst_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rule: descriptor i copies
    unless a later descriptor names the same destination page."""
    n = src_idx.shape[0]
    if n == 0:
        return dst_pool
    order = torch.arange(n, device=dst_idx.device)
    d = dst_idx.long()
    last = torch.full((dst_pool.shape[0],), -1, dtype=torch.long,
                      device=dst_idx.device).scatter_reduce(0, d, order, "amax")
    keep = last[d] == order
    # uint32 has no index kernels on the CPU: move pages as int32 (same bits)
    dst_pool.view(torch.int32).index_copy_(
        0, d[keep], src_pool.view(torch.int32)[src_idx.long()[keep]])
    return dst_pool


def batch_copy_pages(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                     src_idx: torch.Tensor, dst_idx: torch.Tensor) -> torch.Tensor:
    """Copy pages of ``src_pool`` [P, page_words] into ``dst_pool``
    [Q, page_words] (uint32, contiguous) in place; ``src_idx``/``dst_idx``
    are [N] int32 on the same device.  Returns ``dst_pool``."""
    _build.check(src_pool, "batch_copy_pages src_pool", torch.uint32, 2)
    _build.check(dst_pool, "batch_copy_pages dst_pool", torch.uint32, 2)
    _build.check(src_idx, "batch_copy_pages src_idx", torch.int32, 1)
    _build.check(dst_idx, "batch_copy_pages dst_idx", torch.int32, 1)
    _build.same_device("batch_copy_pages", src_pool, dst_pool, src_idx, dst_idx)
    if src_pool.shape[1] != dst_pool.shape[1]:
        raise ValueError(f"batch_copy_pages: page sizes differ: "
                         f"{src_pool.shape[1]} vs {dst_pool.shape[1]} words")
    if src_idx.shape != dst_idx.shape:
        raise ValueError(f"batch_copy_pages: src_idx {tuple(src_idx.shape)} "
                         f"!= dst_idx {tuple(dst_idx.shape)}")
    if src_pool.device.type == "cpu":
        return batch_copy_pages_plain(src_pool, dst_pool, src_idx, dst_idx)
    n = src_idx.shape[0]
    if n and dst_pool.shape[1]:
        _build.launch("dsa_batch_copy_pages", src_pool.data_ptr(),
                      dst_pool.data_ptr(), src_idx.data_ptr(), dst_idx.data_ptr(),
                      n, src_pool.shape[0], dst_pool.shape[0], dst_pool.shape[1],
                      _build.stream(dst_pool))
        _build.count(batch_copy_pages)
    return dst_pool


batch_copy_pages.launches = 0
