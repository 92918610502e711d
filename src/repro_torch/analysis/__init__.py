"""Runtime analysis for the descriptor/Future programming model.

  desclint   descriptor validity (paper §3.2: the 64-byte contract):
             op-specific operand checks enforced at ``Device.submit`` via
             ``make_device(validate="strict"|"warn"|"off")``; typed
             ``DescriptorError`` taxonomy (DESC1xx codes).
  lockcheck  opt-in lockdep-style runtime detector: lock-acquisition-order
             graph over the engine/completion locks, cycle and
             held-lock-while-notifying hazards.

Import discipline: ``repro_torch.core`` modules import
``repro_torch.analysis.lockcheck`` at module-import time and ``desclint``
imports ``repro_torch.core.descriptor``; this package ``__init__``
therefore stays LAZY (no eager submodule imports) to keep the graph acyclic.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("desclint", "lockcheck")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
