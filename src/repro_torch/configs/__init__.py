from repro_torch.configs.base import (
    EncoderConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    SSMConfig,
    VLMConfig,
    YarnConfig,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    applicable,
    get_config,
    runnable_cells,
)

__all__ = [
    "ARCH_IDS",
    "EncoderConfig",
    "HybridConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ShapeConfig",
    "SSMConfig",
    "VLMConfig",
    "YarnConfig",
    "all_cells",
    "applicable",
    "get_config",
    "runnable_cells",
]
