"""Mamba2-1.3B — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] d_model 2048, 48 layers, d_state 128,
expand 2 (d_inner 4096), head_dim 64 (64 SSM heads), conv width 4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2/SSD)",
)
