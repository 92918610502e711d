"""Memory Fill kernel (paper Table 1, "Fill").

``fill_words`` fills a flat uint32 word buffer with a repeating 1-, 2- or
4-word pattern (the paper's 4/8/16-byte patterns).  On a CUDA device it
launches ``fill_words_kernel`` (csrc/dsa_kernels.cu), which replaces the JAX
package's Pallas ``fill_words`` (repro/kernels/fill.py:28); on the CPU it
runs the plain version.  The pattern is an immediate, as in a DSA
descriptor: its words go to the kernel by value, so a fill reads nothing
from device memory and needs no host-to-device copy.  ``n_pe`` keeps the
reference's PE lanes (contiguous spans, as in ``memcpy_words``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fill_ref

PATTERN_WORDS = (1, 2, 4)


def fill_words_plain(n_words: int, pattern: Sequence[int], *, n_pe: int = 1,
                     device="cpu") -> torch.Tensor:
    """Plain PyTorch version: ``ref.fill_ref``, the pattern tiled over the
    buffer (PE spans do not change the result)."""
    del n_pe
    return fill_ref((n_words,), pattern, device=device)


def pattern_words(pattern) -> tuple:
    """The pattern as a tuple of 1, 2 or 4 Python ints in [0, 2**32).  A
    pattern on the card is read back once (it is a descriptor immediate)."""
    if isinstance(pattern, torch.Tensor):
        t = pattern.detach().reshape(-1)
        if t.element_size() == 4:
            t = t.view(torch.int32)
        words = t.cpu().tolist()
    elif isinstance(pattern, int):
        words = [pattern]
    else:
        words = [int(w) for w in pattern]
    if len(words) not in PATTERN_WORDS:
        raise ValueError(f"fill: the pattern must have 1, 2 or 4 words, got {len(words)}")
    return tuple(int(w) & 0xFFFFFFFF for w in words)


def pattern_quad(pat: tuple) -> tuple:
    """A pattern of 1, 2 or 4 words repeated to the 4 words of the kernels'
    ``uint4`` argument (p divides 4, so word i of a buffer is word i % 4)."""
    return pat * (4 // len(pat))


def fill_words(n_words: int, pattern: Sequence[int], *, n_pe: int = 1,
               device="cuda") -> torch.Tensor:
    """A new [n_words] uint32 buffer on ``device`` with word i equal to
    ``pattern[i % len(pattern)]``; ``pattern`` is 1, 2 or 4 ints."""
    pat = pattern_words(pattern)
    if n_words < 0:
        raise ValueError(f"fill_words: n_words must be >= 0, got {n_words}")
    if not 1 <= n_pe <= 65535:
        raise ValueError(f"fill_words: n_pe must be in [1, 65535], got {n_pe}")
    device = torch.device(device)
    if device.type == "cpu":
        return fill_words_plain(n_words, pat, n_pe=n_pe, device=device)
    if device.type != "cuda":
        raise ValueError(f"fill_words: device {device} is not supported; the kernel "
                         f"runs on CUDA, the plain version on the CPU")
    dst = torch.empty(n_words, dtype=torch.uint32, device=device)
    if n_words:
        _build.launch("dsa_fill_words", dst.data_ptr(), n_words, n_pe, *pattern_quad(pat),
                      _build.stream(dst))
        _build.count(fill_words)
    return dst


fill_words.launches = 0
