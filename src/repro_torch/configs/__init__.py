from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg, Stage
from repro_torch.configs.registry import ASSIGNED, get_config, list_archs
from repro_torch.configs.shapes import (
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
    ShapeCfg, cell_is_runnable, get_shape,
)

__all__ = [
    "ArchConfig", "MoECfg", "SSMCfg", "Stage", "ASSIGNED", "get_config",
    "list_archs", "ALL_SHAPES", "ShapeCfg", "get_shape", "cell_is_runnable",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
