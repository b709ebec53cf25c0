"""Hand-written Hopper kernels of the port, with their plain versions:

  fused_reduce  K1, the binary streaming plugin (combine + cast)
  quantize      K2/K3, the per-block int8 wire codec
  matmul        K4, the tiled fp32-accumulating matrix product
  embedding_gather  K5, the embedding row gather
  ref           plain PyTorch versions of K1-K5 (the CPU path and the
                yardstick the kernels are held to on the card)
  ops           public entry points: kernel on CUDA, plain on the CPU
  _build        nvcc build of csrc/ into one ctypes-loaded library

Nothing here builds or touches the card at import time.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
