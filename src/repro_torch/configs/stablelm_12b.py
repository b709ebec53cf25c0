"""StableLM-2-12B — dense GQA decoder.

[hf:stabilityai/stablelm-2-12b; hf] 40L, d 5120, 32H/8KV (head 160),
ffn 13824, vocab 100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100352, rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-12b",
)
