"""Models served by the port (reference: `repro/models/`).

  common  Builder: one param definition -> a mesh-stacked tensor or its
          PartitionSpec entries
  dlrm    distributed DLRM inference, the paper's use case 2
"""
from repro_torch.models import common, dlrm

__all__ = ["common", "dlrm"]
