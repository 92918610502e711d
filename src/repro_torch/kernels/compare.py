"""Memory Compare kernel (paper Table 1, "Compare").

``compare_words`` compares two flat uint32 word buffers and returns DSA's
completion-record pair: (equal?, index of the first differing word | -1),
as a 0-d bool and a 0-d int32 on the buffers' device.  On a CUDA tensor it
launches ``compare_words_kernel`` (csrc/dsa_kernels.cu), which replaces the
JAX package's Pallas ``compare_words`` (repro/kernels/compare.py:25) and the
jnp reduction of its per-block records in ``ops.compare``: the kernel
reduces on the card, so the pair needs no host sync.  On a CPU tensor it
runs the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import compare_ref

#: word indices are reported as int32, as the reference reports them
MAX_WORDS = 2**31 - 1

#: plain PyTorch version: the first index of the word views' mismatch mask
compare_words_plain = compare_ref


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
