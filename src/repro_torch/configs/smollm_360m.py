"""SmolLM-360M — llama-arch small model.

[hf:HuggingFaceTB/SmolLM-360M; hf] 32L, d 960, 15H/5KV (head 64),
ffn 2560, vocab 49152, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True, rope_theta=1e4,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
