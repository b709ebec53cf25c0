"""Qwen3-30B-A3B — fine-grained MoE: 128 experts, top-8, expert ffn 768.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L, d 2048, 32H/4KV head 128, vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936, qk_norm=True,
    n_experts=128, experts_per_token=8, moe_d_ff=768,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
