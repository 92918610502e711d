"""Apply Delta Record kernel (paper Table 1, "Compare").

``delta_apply_words`` returns a copy of a reference word buffer with an
(offset, word) record scattered in: entries in record order, ``off < 0``
(pads) and ``off >= n_words`` skipped, the last of several entries naming
one word winning.  These are the semantics of the JAX package's Pallas
kernel, a serial walk over the record (repro/kernels/delta_apply.py:41).

On CUDA tensors it launches the copy kernel and four passes over the record
(csrc/dsa_kernels.cu, ``delta_zero_kernel`` .. ``delta_store_kernel``): the
output word itself is the claim slot of an ``atomicMax`` of the entry
order, so duplicates resolve in O(cap) with cap bytes of scratch, for a
DSA-sized record and a checkpoint-sized one alike.  Offsets on the card are
never read back to the host.  On CPU tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def delta_apply_words_plain(ref: torch.Tensor, offsets: torch.Tensor,
                            data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a stable sort of the valid offsets puts the
    entries naming one word next to each other in record order, and the
    last of each run is stored (through int32 views: the CPU has no
    ``index_put`` for uint32)."""
    out = ref.clone().view(torch.int32)
    n = ref.numel()
    off = offsets.long()
    valid = (off >= 0) & (off < n)
    off, vals = off[valid], data.view(torch.int32)[valid]
    if off.numel():
        s_off, perm = torch.sort(off, stable=True)
        last = torch.ones_like(s_off, dtype=torch.bool)
        last[:-1] = s_off[1:] != s_off[:-1]
        out[s_off[last]] = vals[perm[last]]
    return out.view(torch.uint32)


def delta_apply_words(ref: torch.Tensor, offsets: torch.Tensor,
                      data: torch.Tensor) -> torch.Tensor:
    """A new [n] uint32 buffer: ``ref`` ([n] uint32) with the record
    (``offsets`` [cap] int32, ``data`` [cap] uint32) applied.  All three
    contiguous, on one device."""
    _build.check(ref, "delta_apply_words ref", torch.uint32, 1)
    _build.check(offsets, "delta_apply_words offsets", torch.int32, 1)
    _build.check(data, "delta_apply_words data", torch.uint32, 1)
    _build.same_device("delta_apply_words", ref, offsets, data)
    if offsets.shape != data.shape:
        raise ValueError(f"delta_apply_words: offsets {tuple(offsets.shape)} vs data "
                         f"{tuple(data.shape)}")
    if ref.device.type == "cpu":
        return delta_apply_words_plain(ref, offsets, data)
    out = torch.empty_like(ref)
    cap = offsets.numel()
    win = torch.empty(cap, dtype=torch.uint8, device=ref.device)
    _build.launch("dsa_delta_apply_words", ref.data_ptr(), out.data_ptr(), ref.numel(),
                  offsets.data_ptr(), data.data_ptr(), cap, win.data_ptr(),
                  _build.stream(ref))
    _build.count(delta_apply_words)
    return out


delta_apply_words.launches = 0
