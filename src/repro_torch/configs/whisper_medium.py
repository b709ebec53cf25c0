"""Whisper-medium — encoder-decoder; conv audio frontend is a STUB
(input_specs() provides precomputed frame embeddings).

[arXiv:2212.04356; unverified] 24+24L, d 1024, 16H (MHA: kv=16, head 64),
ffn 4096, vocab 51865.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, rope_theta=1e4,
    source="arXiv:2212.04356 (Whisper)",
)
