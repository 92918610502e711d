"""Apply Delta Record kernel (paper Table 1, "Compare").

``delta_apply_words`` returns a copy of a reference word buffer with an
(offset, word) record scattered in: entries in record order, ``off < 0``
(pads) and ``off >= n_words`` skipped, the last of several entries naming
one word winning.  These are the semantics of the JAX package's Pallas
kernel, a serial walk over the record (repro/kernels/delta_apply.py:41).

On CUDA tensors (csrc/dsa_kernels.cu) one scan reads the record once and
finds ``hi`` (one past the last valid entry) and whether the valid entries
are an ascending prefix, the shape ``delta_record_words`` writes, where no
two entries name one word (the fast path).  On the ring route (buffers the
copy's TMA ring takes: 16-byte aligned, a multiple of 4 words, at least one
ring per SM) the scan also finds each 32 KiB chunk's first entry, and the
copy patches the entries into each chunk in shared memory between its load
and its store; elsewhere the copy runs first and the scan stores the
entries.  A record that is not an ascending prefix then takes the claim
rule over ``[0, hi)``, the output word itself the claim slot of an
``atomicMax`` of the entry order.  Offsets on the card are never read back
to the host.  On CPU tensors it runs the plain version;
``delta_apply_words_schedule_plain`` models the kernels' schedule step by
step for the CPU tests.
"""
from __future__ import annotations

from typing import Tuple

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


#: words of one chunk of the copy's TMA ring (csrc/dsa_kernels.cu kCopyChunk / 4)
CHUNK_WORDS = 32 * 1024 // 4
#: words of scratch ahead of the chunk bounds (hi, the flag, the barrier, a
#: pad, the 64-bit count of bounds)
STATE_WORDS = 6


def delta_scan_plain(offsets: torch.Tensor, n: int, chunk_words: int = CHUNK_WORDS
                     ) -> Tuple[int, bool, torch.Tensor]:
    """The kernels' scan: ``hi``, one past the last valid entry (0 for
    none); whether the valid entries are an ascending prefix, tested on
    each adjacent pair (``valid(i+1)`` implies ``valid(i)`` and
    ``off[i] < off[i+1]``) and on the count of chunk bounds (at most one a
    chunk); and ``first``, the ring route's bounds: ``first[c] = i + 1`` for
    every chunk c whose first word lies in ``(off[i], off[i+1]]`` of an
    ascending valid pair, -1 where no pair wrote."""
    off = offsets.long()
    valid = (off >= 0) & (off < n)
    live = torch.nonzero(valid).reshape(-1)
    hi = int(live[-1]) + 1 if live.numel() else 0
    asc = valid[:-1] & valid[1:] & (off[:-1] < off[1:])
    broken = valid[1:] & ~asc
    n_chunks = -(-n // chunk_words)
    first = torch.full((n_chunks,), -1, dtype=torch.int64)
    pairs = torch.nonzero(asc).reshape(-1)
    lo = off[pairs] // chunk_words + 1
    count = off[pairs + 1] // chunk_words - lo + 1
    prefix = not bool(broken.any()) and int(count.sum()) <= n_chunks
    if prefix and pairs.numel():
        # pair i writes i + 1 to its chunks lo_i .. lo_i + count_i - 1
        seg = torch.repeat_interleave(torch.arange(pairs.numel()), count)
        start = torch.cumsum(count, 0) - count
        first[lo[seg] + torch.arange(seg.numel()) - start[seg]] = pairs[seg] + 1
    return hi, prefix, first


def delta_apply_words_schedule_plain(ref: torch.Tensor, offsets: torch.Tensor,
                                     data: torch.Tensor, *, ring: bool,
                                     chunk_words: int = CHUNK_WORDS
                                     ) -> Tuple[torch.Tensor, str, int]:
    """A PyTorch model of the kernels' schedule, step by step.  The scan;
    then on the ring route (``ring``) the copy chunk by chunk, each chunk's
    entries ``[start(c), start(c + 1))`` patched into it when the record is
    an ascending prefix (``start(c)`` is 0 up to the first entry's chunk,
    ``hi`` after the last entry's chunk, ``first[c]`` between), else the
    copy and the scan's stores of every valid entry (in reverse record
    order here: CTAs store in no order, and the fast path must not depend on
    it).  Unless the record is an ascending prefix, the claim rule over
    ``[0, hi)`` follows: zero, claim (the largest ``i + 1`` of a word's
    entries), mark, store.  Returns (out, "fast" or "general", hi)."""
    n = ref.numel()
    out = ref.clone().view(torch.int32)
    vals = data.view(torch.int32)
    off = offsets.long()
    if off.numel() == 0 or n == 0:
        return out.view(torch.uint32), "fast", 0
    hi, prefix, first = delta_scan_plain(offsets, n, chunk_words)
    valid = (off >= 0) & (off < n)
    if ring:
        if prefix and hi:
            c_first, c_last = int(off[0]) // chunk_words, int(off[hi - 1]) // chunk_words

            def start(c):
                return 0 if c <= c_first else hi if c > c_last else int(first[c])

            for c in range(-(-n // chunk_words)):
                e0, e1 = start(c), start(c + 1)
                chunk = out[c * chunk_words:(c + 1) * chunk_words]
                rel = off[e0:e1] - c * chunk_words
                assert bool(((rel >= 0) & (rel < chunk.numel())).all())
                chunk[rel] = vals[e0:e1]
    else:
        live = torch.nonzero(valid).reshape(-1).flip(0)
        out[off[live]] = vals[live]
    if prefix:
        return out.view(torch.uint32), "fast", hi
    idx = torch.arange(hi, dtype=torch.int64)
    v, o = valid[:hi], off[:hi]
    out[o[v]] = 0
    out.scatter_reduce_(0, o[v], (idx[v] + 1).to(torch.int32), reduce="amax")
    win = torch.zeros(hi, dtype=torch.bool)
    win[v] = out[o[v]] == (idx[v] + 1).to(torch.int32)
    out[o[win]] = vals[:hi][win]
    return out.view(torch.uint32), "general", hi


def delta_apply_words(ref: torch.Tensor, offsets: torch.Tensor,
                      data: torch.Tensor) -> torch.Tensor:
    """A new [n] uint32 buffer: ``ref`` ([n] uint32) with the record
    (``offsets`` [cap] int32, ``data`` [cap] uint32) applied.  All three
    contiguous, on one device; cap < 2**31."""
    _build.check(ref, "delta_apply_words ref", torch.uint32, 1)
    _build.check(offsets, "delta_apply_words offsets", torch.int32, 1)
    _build.check(data, "delta_apply_words data", torch.uint32, 1)
    _build.same_device("delta_apply_words", ref, offsets, data)
    if offsets.shape != data.shape:
        raise ValueError(f"delta_apply_words: offsets {tuple(offsets.shape)} vs data "
                         f"{tuple(data.shape)}")
    cap = offsets.numel()
    if cap >= 2**31:
        raise ValueError(f"delta_apply_words: a record of {cap} entries is over 2**31 - 1")
    if ref.device.type == "cpu":
        return delta_apply_words_plain(ref, offsets, data)
    out = torch.empty_like(ref)
    win = torch.empty(cap, dtype=torch.uint8, device=ref.device)
    scratch = torch.empty(STATE_WORDS + -(-ref.numel() // CHUNK_WORDS), dtype=torch.int32,
                          device=ref.device)
    _build.launch("dsa_delta_apply_words", ref.data_ptr(), out.data_ptr(), ref.numel(),
                  offsets.data_ptr(), data.data_ptr(), cap, win.data_ptr(),
                  scratch.data_ptr(), _build.stream(ref))
    _build.count(delta_apply_words)
    return out


delta_apply_words.launches = 0
