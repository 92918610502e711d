"""Dualcast kernel (paper Table 1): one source read, two destination writes.

The point of the DSA op is halving the read traffic of a replica write:
``dualcast_words`` reads each word of a flat uint32 buffer once and writes
it to two new buffers.  On a CUDA tensor it launches
``dualcast_words_kernel`` (csrc/dsa_kernels.cu), which replaces the JAX
package's Pallas ``dualcast_words`` (repro/kernels/dualcast.py:22); on a CPU
tensor it runs the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dualcast_ref

#: plain PyTorch version: two clones
dualcast_words_plain = dualcast_ref


def dualcast_words(src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two new copies of ``src`` ([n] uint32, contiguous) on its device."""
    _build.check(src, "dualcast_words src", torch.uint32, 1)
    if src.device.type == "cpu":
        return dualcast_words_plain(src)
    d1 = torch.empty_like(src)
    d2 = torch.empty_like(src)
    if src.numel():
        _build.launch("dsa_dualcast_words", src.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                      src.numel(), _build.stream(src))
        _build.count(dualcast_words)
    return d1, d2


dualcast_words.launches = 0
