"""InternVL2-26B backbone: InternViT-6B (stubbed frontend) + InternLM2-20B.

[arXiv:2404.16821; hf] — transformer backbone only; input_specs() supplies
precomputed patch embeddings for the visual prefix (256 tokens).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    rope_theta=1e6, tie_embeddings=False,
    n_vis_tokens=256,
    source="arXiv:2404.16821 (InternVL2) / InternLM2-20B backbone [hf]",
)
