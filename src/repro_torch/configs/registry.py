"""Architecture registry: ``get_config(arch_id)`` and the canonical cell list.

Cell = (architecture x input shape).  ``applicable(cfg, shape)`` encodes the
assignment rules: long_500k only for sub-quadratic-state archs; decode shapes
skipped for encoder-only stacks (none of the assigned archs are encoder-only —
seamless is enc-dec, its decoder decodes).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    # the port's own: no counterpart in the JAX package
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for one cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode state is unbounded (DESIGN.md)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    """Every assigned (arch, shape) pair, including skip cells."""
    return [(a, s.name) for a in ARCH_IDS for s in SHAPES]


def runnable_cells() -> List[Tuple[str, str]]:
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, _ = applicable(cfg, s)
            if ok:
                out.append((a, s.name))
    return out


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "SHAPES_BY_NAME",
    "get_config",
    "applicable",
    "all_cells",
    "runnable_cells",
]
