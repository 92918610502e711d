"""Memory Fill kernel (paper Table 1, "Fill").

``fill_words`` fills a flat uint32 word buffer with a repeating 1-, 2- or
4-word pattern (the paper's 4/8/16-byte patterns).  On a CUDA device it
launches ``fill_words_kernel`` (csrc/dsa_kernels.cu), which replaces the JAX
package's Pallas ``fill_words`` (repro/kernels/fill.py:28); on the CPU it
runs the plain version.  The pattern is an immediate, as in a DSA
descriptor: its words go to the kernel by value, so a fill reads nothing
from device memory and needs no host-to-device copy.  ``n_pe`` keeps the
reference's PE lanes (contiguous spans, as in ``memcpy_words``).  The
kernel is a one-shot grid: ``fill_words_schedule_plain`` models its
indexing (spans, CTAs, each thread's stores, the ragged tail) on the CPU.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fill_ref, int32_bits

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


#: threads of a CTA and 16-byte stores of a thread (csrc/dsa_kernels.cu
#: kFillThreads, kFillPerThread)
FILL_THREADS, FILL_PER_THREAD = 128, 2


def fill_launch(n_words: int, n_pe: int, aligned: bool) -> Tuple[int, int]:
    """(span in words, CTAs a span) of the kernel's launch: spans start on a
    multiple of 4 words; a CTA covers ``FILL_THREADS * FILL_PER_THREAD``
    uint4s of an aligned output, as many words of an unaligned one."""
    span = -(-n_words // n_pe)
    span = -(-span // 4) * 4
    items = span // 4 if aligned else span
    return span, max(-(-items // (FILL_THREADS * FILL_PER_THREAD)), 1)


def fill_words_schedule_plain(n_words: int, pattern: Sequence[int], *, n_pe: int = 1,
                              aligned: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CPU model of the kernel's indexing: CTA (b, y) of span y, thread t,
    store u writes uint4 ``b * FILL_THREADS * FILL_PER_THREAD + u *
    FILL_THREADS + t`` of the span (that word of an unaligned output), and
    the first threads of CTA (0, y) the span's ragged tail.  Returns the
    buffer and the number of stores that reached each word."""
    quad = torch.tensor([int32_bits(w) for w in pattern_quad(pattern_words(pattern))],
                        dtype=torch.int32)
    buf = torch.zeros(n_words, dtype=torch.int32)
    writes = torch.zeros(n_words, dtype=torch.int32)
    span, grid_x = fill_launch(n_words, n_pe, aligned)
    b, u, t = torch.meshgrid(torch.arange(grid_x), torch.arange(FILL_PER_THREAD),
                             torch.arange(FILL_THREADS), indexing="ij")
    item = (b * FILL_PER_THREAD * FILL_THREADS + u * FILL_THREADS + t).reshape(-1)
    for y in range(n_pe):
        begin, end = y * span, min((y + 1) * span, n_words)
        if begin >= end:
            continue
        if aligned:
            nv = (end - begin) // 4
            j = item[item < nv]
            words = (begin + 4 * j[:, None] + torch.arange(4)).reshape(-1)
            tail = begin + 4 * nv + torch.arange(FILL_THREADS)
            words = torch.cat([words, tail[tail < end]])
        else:
            words = begin + item
            words = words[words < end]
        buf[words] = quad[words % 4]
        writes.index_add_(0, words, torch.ones_like(words, dtype=torch.int32))
    return buf.view(torch.uint32), writes


def fill_words_into(dst: torch.Tensor, pattern: Sequence[int], *,
                    n_pe: int = 1) -> torch.Tensor:
    """Fill ``dst`` ([n] uint32, contiguous) in place, word i with
    ``pattern[i % len(pattern)]``, and return it.  An output that is not
    16-byte aligned takes the kernel's word-wise route."""
    pat = pattern_words(pattern)
    _build.check(dst, "fill_words dst", torch.uint32, 1)
    if not 1 <= n_pe <= 65535:
        raise ValueError(f"fill_words: n_pe must be in [1, 65535], got {n_pe}")
    n_words = dst.numel()
    if dst.device.type == "cpu":
        return dst.copy_(fill_words_plain(n_words, pat, n_pe=n_pe))
    if n_words:
        _build.launch("dsa_fill_words", dst.data_ptr(), n_words, n_pe, *pattern_quad(pat),
                      _build.stream(dst))
        _build.count(fill_words)
    return dst


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
    return fill_words_into(torch.empty(n_words, dtype=torch.uint32, device=device), pat,
                           n_pe=n_pe)


fill_words.launches = 0
