"""Mixtral-8x7B — MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088; hf] 32L, d 4096, 32H/8KV head 128, expert ffn 14336,
vocab 32000, SWA window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=32000,
    n_experts=8, experts_per_token=2, moe_d_ff=14336,
    sliding_window=4096, rope_theta=1e6,
    source="arXiv:2401.04088 (Mixtral)",
)
