"""Hymba-1.5B — hybrid: parallel attention + SSM heads in every layer;
SWA everywhere except 3 global-attention layers.

[arXiv:2411.13676; hf] 32L, d 1600, 25H/5KV (head 64), ffn 5504,
vocab 32001, ssm_state 16.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    sliding_window=1024, global_attn_layers=(0, 15, 31),
    rope_theta=1e4,
    source="arXiv:2411.13676 (Hymba)",
)
