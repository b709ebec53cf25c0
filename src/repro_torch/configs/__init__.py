"""Configurations the port serves, copied from `repro/configs/` (the port
imports nothing of the reference package, its jax-free modules
included):

  base   ArchConfig, ShapeConfig, SHAPES, ARCH_IDS, ASSIGNED_ARCHS,
         get_config, reduced_config (the LM architectures; one module
         per arch, e.g. `qwen3_0p6b`) and ParallelConfig
  dlrm   DLRMConfig, CONFIG (the paper's Table 2 DLRM), reduced()
"""
from repro_torch.configs.base import (
    ARCH_IDS, ASSIGNED_ARCHS, SHAPES, ArchConfig, ParallelConfig,
    ShapeConfig, get_config, reduced_config,
)
from repro_torch.configs.dlrm import CONFIG, DLRMConfig, reduced

__all__ = [
    "ARCH_IDS", "ASSIGNED_ARCHS", "ArchConfig", "CONFIG", "DLRMConfig",
    "ParallelConfig", "SHAPES", "ShapeConfig", "get_config", "reduced",
    "reduced_config",
]
