"""Memory Copy kernel (paper Table 1, "Move").

``memcpy_words`` copies a flat uint32 word buffer.  On a CUDA tensor it
launches ``memcpy_words_kernel`` (csrc/dsa_kernels.cu), which replaces the
JAX package's Pallas ``memcpy_words`` (repro/kernels/memcpy.py:20); on a CPU
tensor it runs the plain version.  ``n_pe`` keeps the reference's PE lanes:
the buffer is copied as ``n_pe`` contiguous spans (G5, PE-level parallelism).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def memcpy_words_plain(src: torch.Tensor, *, n_pe: int = 1) -> torch.Tensor:
    """Plain PyTorch version: a copy is a copy whatever the span split."""
    del n_pe
    return src.clone()


def memcpy_words(src: torch.Tensor, *, n_pe: int = 1) -> torch.Tensor:
    """Copy ``src`` ([n] uint32, contiguous) into a new buffer."""
    _build.check(src, "memcpy_words src", torch.uint32, 1)
    if not 1 <= n_pe <= 65535:
        raise ValueError(f"memcpy_words: n_pe must be in [1, 65535], got {n_pe}")
    if src.device.type == "cpu":
        return memcpy_words_plain(src, n_pe=n_pe)
    dst = torch.empty_like(src)
    if src.numel():
        _build.launch("dsa_memcpy_words", src.data_ptr(), dst.data_ptr(),
                      src.numel(), n_pe, _build.stream(src))
        _build.count(memcpy_words)
    return dst


memcpy_words.launches = 0
