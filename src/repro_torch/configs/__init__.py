"""Configurations the port serves, copied from `repro/configs/` (the port
imports nothing of the reference package, its jax-free modules
included):

  dlrm   DLRMConfig, CONFIG (the paper's Table 2 DLRM), reduced()
  base   ParallelConfig (the parallelism knobs; ArchConfig and
         get_config wait for the LM stack)
"""
from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.dlrm import CONFIG, DLRMConfig, reduced

__all__ = ["CONFIG", "DLRMConfig", "ParallelConfig", "reduced"]
