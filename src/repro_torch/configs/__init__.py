from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ClusterKVConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    all_cells,
    cells,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ClusterKVConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "all_cells",
    "cells",
    "get_config",
    "reduced_config",
]
