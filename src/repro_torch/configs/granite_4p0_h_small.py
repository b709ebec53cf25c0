"""Granite-4.0-H-Small (32B-A9B) — hybrid Mamba2 / NoPE-attention with a
72-expert MoE and a shared expert in every layer (`granitemoehybrid`).

[hf:ibm-granite/granite-4.0-h-small config.json] 40 layers: 36 Mamba2
and 4 GQA attention layers (5, 15, 25, 35), no positional embedding; d
4096; Mamba2 128 heads of 64, d_state 128, 1 group, conv 4 with bias,
chunk 256; attention 32 / 8 heads of 128, softmax scale 1/128; MoE 72
experts, top-10 (softmax over the top-10 logits), SwiGLU 768, one shared
SwiGLU expert of 1536; embeddings x 12, both residual branches x 0.22,
logits / 16; vocab 100352, tied; RMSNorm eps 1e-5. Its layer:

    h = h + 0.22 mixer(norm(h))
    h = h + 0.22 (moe(norm(h)) + shared(norm(h)))
"""
from repro_torch.configs.base import LayerTypedConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = LayerTypedConfig(
    name="granite-4.0-h-small", family="moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=100352, tie_embeddings=True, norm_eps=1e-5,
    n_experts=72, experts_per_token=10, moe_d_ff=768,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    ssm_chunk=256,
    layer_types=_PERIOD * 4, shared_d_ff=1536,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, attention_multiplier=1.0 / 128, use_rope=False,
    ssm_conv_bias=True, moe_dropless=True, expert_init_fan_in=True,
    source="hf:ibm-granite/granite-4.0-h-small",
)
