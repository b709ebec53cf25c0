"""Qwen3-0.6B — dense GQA with qk_norm, wide head_dim (128 > d/H).

[hf:Qwen/Qwen3-0.6B; hf] 28L, d 1024, 16H/8KV head_dim 128, ffn 3072,
vocab 151936, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-0.6B",
)
