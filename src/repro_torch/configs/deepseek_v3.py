"""DeepSeek-V3 (671B-A37B) — multi-head latent attention (MLA) in every
layer, three leading dense layers, then a 256-expert MoE with one shared
expert and the group-limited sigmoid router (`noaux_tc`).

[hf:deepseek-ai/DeepSeek-V3 config.json] 61 layers, d 7168, vocab 129280
(untied), RMSNorm eps 1e-6. MLA: 128 heads, q through a 1536-wide
down-projection, its RMSNorm and an up-projection to 128 + 64 per head;
one latent c_kv of 512 (after its RMSNorm) and one rotated key k_pe of
64 per token, shared by every head; each head's k_nope (128) and v (128)
from c_kv. RoPE theta 1e4 with YaRN (factor 40 over 4096 positions,
beta_fast 32, beta_slow 1, mscale = mscale_all_dim = 1), interleaved
pairs; softmax scale m^2 / sqrt(192), m = 0.1 ln 40 + 1. Layers 0-2: a
dense SwiGLU of 18432. Layers 3-60: 256 routed SwiGLU experts of 2048,
top-8, and one shared expert of 2048; sigmoid scores, a correction bias
for selection only, 8 groups of which the 4 best by their two best
biased scores are kept, the gates normalised and x 2.5. One multi-token
prediction layer (never run by a first-token prefill; not built). Its
layer (`models/blocks.py`):

    h = h + mla(norm(h))
    h = h + ffn(norm(h))    ffn: swiglu (layers 0-2), else
                            sum_i w_i expert_i + shared
"""
from repro_torch.configs.base import LayerTypedConfig

_FIRST_DENSE = 3
_LAYERS = 61

CONFIG = LayerTypedConfig(
    name="deepseek-v3", family="moe",
    n_layers=_LAYERS, d_model=7168, n_heads=128, n_kv_heads=128,
    head_dim=192, d_ff=18432, vocab_size=129280, tie_embeddings=False,
    rope_theta=10000.0, norm_eps=1e-6,
    n_experts=256, experts_per_token=8, moe_d_ff=2048,
    layer_types=("mla_dense",) * _FIRST_DENSE
    + ("mla_moe",) * (_LAYERS - _FIRST_DENSE),
    shared_d_ff=2048, moe_dropless=True, expert_init_fan_in=True,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    yarn=(40.0, 4096, 32.0, 1.0, 1.0, 1.0),
    router_scoring="sigmoid", router_groups=8,
    router_topk_groups=4, routed_scaling=2.5, router_experts=256,
    source="hf:deepseek-ai/DeepSeek-V3",
)
