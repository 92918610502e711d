"""Transparent offload (DTO analogue).

The paper ships two software layers above raw descriptors:
  * DML: an explicit C/C++ API with async offload and load balancing;
  * DTO: LD_PRELOAD interception of memcpy/memset/memcmp.

The DML-style facade lives in core/device.py: ``Device`` owns N engine
instances behind a pluggable SubmitPolicy and returns ``Future`` objects
from every submit.  This module keeps ``dto``, the drop-in layer: copy,
fill and compare functions over torch tensors that route through the
active Device for transfers of at least ``min_bytes``, and run plain
PyTorch below it or outside ``dto_enabled``.

The deprecated ``Stream`` / ``make_stream`` shims were removed: use
``make_device`` and Futures.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.core.device import Device, make_device
from repro_torch.kernels.ops import from_words

_REMOVED_SHIMS = ("Stream", "make_stream")


def __getattr__(name: str):
    if name in _REMOVED_SHIMS:
        raise AttributeError(
            f"repro_torch.core.api.{name} was removed: the deprecated Stream shim "
            "API is gone. Use repro_torch.core.make_device / Device; submissions "
            "return Future objects.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# --------------------------------------------------------------------------- DTO
_active: threading.local = threading.local()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@contextlib.contextmanager
def dto_enabled(device: Optional[Device] = None, min_bytes: int = 8192):
    """Transparent offload: inside this context, dto.memcpy/memset/memcmp
    route through the engine for transfers >= min_bytes (the paper's
    CacheLib study offloads >= 8KB: 4.8% of calls, 96.4% of bytes).  With
    no ``device``, a new ``make_device()``: the CUDA card."""
    prev = getattr(_active, "ctx", None)
    _active.ctx = (device or make_device(), min_bytes)
    try:
        yield _active.ctx[0]
    finally:
        _active.ctx = prev


class dto:
    """memcpy/memset/memcmp interposers (synchronous, like the DTO library)."""

    @staticmethod
    def memcpy(src: torch.Tensor) -> torch.Tensor:
        ctx = getattr(_active, "ctx", None)
        if ctx and _nbytes(src) >= ctx[1]:
            return ctx[0].memcpy(src)
        return src.clone()

    @staticmethod
    def memset(x: torch.Tensor, byte: int = 0) -> torch.Tensor:
        """At or above the threshold every byte becomes ``byte`` (a fill of
        the word ``byte`` x 4).  Below it, as in the JAX package, the
        elements become the VALUE ``byte`` (``full_like``): float32 gives
        171.0 for 0xAB, not the bits 0xABABABAB."""
        ctx = getattr(_active, "ctx", None)
        nbytes = _nbytes(x)
        if ctx and nbytes >= ctx[1]:
            word = int.from_bytes(bytes([byte]) * 4, "little")
            d = ctx[0]
            out = d.wait(d.fill_async([word], nbytes // 4))
            return from_words(out, nbytes // 4, tuple(x.shape), x.dtype)
        return torch.full_like(x, 0 if byte == 0 else byte)

    @staticmethod
    def memcmp(a: torch.Tensor, b: torch.Tensor) -> bool:
        ctx = getattr(_active, "ctx", None)
        if ctx and _nbytes(a) >= ctx[1]:
            eq, _ = ctx[0].compare(a, b)
            return bool(eq)
        return bool(torch.equal(a, b))
