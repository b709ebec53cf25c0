"""Parallel machinery of the port (reference: `repro/parallel/`).

  ops     ParCtx: every TP/FSDP communication pattern through the engine
  stages  the serving step builders (prefill, decode_step) and params
"""
from repro_torch.parallel.ops import ParCtx, local_matmul

__all__ = ["ParCtx", "local_matmul"]
