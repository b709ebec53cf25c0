"""Qwen3-14B — dense GQA decoder with qk_norm.

[hf:Qwen/Qwen3-8B family; hf] 40L, d 5120, 40H/8KV, head_dim 128,
ffn 17408, vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-14B",
)
