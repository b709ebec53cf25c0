"""Models served by the port (reference: `repro/models/`).

  common     Builder (one param definition -> a mesh-stacked tensor or its
             spec entries), norms, rope, activations
  dlrm       distributed DLRM inference, the paper's use case 2
  attention  GQA attention: the blocked flash forward, decode attention
             with the engine flash-combine
  mlp        the dense SwiGLU MLP
  blocks     the dense/VLM transformer block and the layer stack
  lm         embeddings, the vocab-parallel greedy head, the forward
  serve      prefill and single-token decode over sharded KV caches
"""
from repro_torch.models import (
    attention, blocks, common, dlrm, lm, mlp, serve,
)

__all__ = ["attention", "blocks", "common", "dlrm", "lm", "mlp", "serve"]
