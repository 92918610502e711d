"""Memory Compare and Compare Pattern kernels (paper Table 1, "Compare").

``compare_words`` compares two flat uint32 word buffers and
``compare_pattern_words`` one buffer against a repeating 1-, 2- or 4-word
pattern; both return DSA's completion-record pair: (equal?, index of the
first differing word | -1), as a 0-d bool and a 0-d int32 on the buffer's
device.  On a CUDA tensor they launch ``compare_words_kernel`` and
``compare_pattern_kernel`` (csrc/dsa_kernels.cu), which replace the JAX
package's Pallas ``compare_words`` and ``compare_pattern_words``
(repro/kernels/compare.py:25,61) and the jnp reduction of their per-block
records in ``ops.compare`` / ``ops.compare_pattern``: the kernels reduce on
the card, so the pair needs no host sync.  On a CPU tensor they run the
plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fill import pattern_quad, pattern_words
from repro_torch.kernels.ref import compare_pattern_ref, compare_ref

#: word indices are reported as int32, as the reference reports them
MAX_WORDS = 2**31 - 1

#: plain PyTorch versions: the first index of the word views' mismatch mask
compare_words_plain = compare_ref
compare_pattern_words_plain = compare_pattern_ref


def compare_words(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first differing word | -1) of ``a`` and ``b`` ([n] uint32,
    contiguous, on one device)."""
    _build.check(a, "compare_words a", torch.uint32, 1)
    _build.check(b, "compare_words b", torch.uint32, 1)
    _build.same_device("compare_words", a, b)
    if a.shape != b.shape:
        raise ValueError(f"compare_words: {tuple(a.shape)} vs {tuple(b.shape)} words")
    if a.numel() > MAX_WORDS:
        raise ValueError(f"compare_words: {a.numel()} words exceed int32 indices")
    if a.device.type == "cpu":
        return compare_words_plain(a, b)
    state = torch.empty(2, dtype=torch.int32, device=a.device)
    equal = torch.empty((), dtype=torch.bool, device=a.device)
    first = torch.empty((), dtype=torch.int32, device=a.device)
    _build.launch("dsa_compare_words", a.data_ptr(), b.data_ptr(), a.numel(),
                  state.data_ptr(), equal.data_ptr(), first.data_ptr(), _build.stream(a))
    _build.count(compare_words)
    return equal, first


compare_words.launches = 0


def compare_pattern_words(a: torch.Tensor, pattern) -> Tuple[torch.Tensor, torch.Tensor]:
    """(equal?, first word i with ``a[i] != pattern[i % p]`` | -1) of ``a``
    ([n] uint32, contiguous).  ``pattern`` is an immediate of 1, 2 or 4
    words (ints, or a tensor read once), as for ``fill.fill_words``."""
    pat = pattern_words(pattern)
    _build.check(a, "compare_pattern_words a", torch.uint32, 1)
    if a.numel() > MAX_WORDS:
        raise ValueError(f"compare_pattern_words: {a.numel()} words exceed int32 indices")
    if a.device.type == "cpu":
        return compare_pattern_words_plain(a, pat)
    state = torch.empty(2, dtype=torch.int32, device=a.device)
    equal = torch.empty((), dtype=torch.bool, device=a.device)
    first = torch.empty((), dtype=torch.int32, device=a.device)
    _build.launch("dsa_compare_pattern_words", a.data_ptr(), a.numel(),
                  *pattern_quad(pat), state.data_ptr(), equal.data_ptr(),
                  first.data_ptr(), _build.stream(a))
    _build.count(compare_pattern_words)
    return equal, first


compare_pattern_words.launches = 0
