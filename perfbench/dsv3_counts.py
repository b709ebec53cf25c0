"""Operations that DeepSeek-V3's prefill needs, from the configuration
file's sizes alone (the published config's keys and the expert share
beside them), for `dsv3_mfu`.

As `bench_counts` counts them: each multiply-add two operations, what
the work needs and not what an implementation does. A prompt of S
tokens, per layer:

  MLA        the projections (q's down- and up-projection, the latent and
             rotated key's, the per-head k_nope / v up-projection, the
             out-projection); the core at its causal half: q k^T at the
             query / key width (nope + rope), p v at v's width
  dense      layers before `first_k_dense_replace`: the SwiGLU of
             `intermediate_size`
  MoE        the router over its published width; the routed experts
             held here at the assignments they take under uniform
             routing (top-k x held / router width a token: 2 of DeepSeek-
             V3's 8 on one node's 64 of 256), not the dispatch's padded
             capacity; the shared expert
  head       the last position's logits alone (2 d V)
"""
from __future__ import annotations


def _causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal n x n product, the diagonal in."""
    return n * (n + 1) // 2


def mla_params(cfg: dict) -> int:
    """The MLA projections' multiply-adds a token (their weights)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    q, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    return d * q + q * h * (nope + rope) + d * (r + rope) \
        + r * h * (nope + v) + h * v * d


def mla_flops(cfg: dict, s: int) -> int:
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    core = 2 * h * (qk + cfg["v_head_dim"]) * _causal_pairs(s)
    return 2 * s * mla_params(cfg) + core


def swiglu_flops(cfg: dict, s: int, width: int) -> int:
    return 2 * s * 3 * cfg["hidden_size"] * width


def moe_flops(cfg: dict, s: int) -> int:
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    width = cfg["router_experts"]
    held = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / width
    return 2 * s * d * width + round(held * swiglu_flops(cfg, s, f)) \
        + cfg["n_shared_experts"] * swiglu_flops(cfg, s, f)


def prefill_flops(cfg: dict, s: int) -> int:
    """One prompt of `s` tokens through the configuration's layers and
    the head at its last position."""
    n, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    layers = n * mla_flops(cfg, s) \
        + min(dense, n) * swiglu_flops(cfg, s, cfg["intermediate_size"]) \
        + max(0, n - dense) * moe_flops(cfg, s)
    return layers + 2 * cfg["hidden_size"] * cfg["vocab_size"]
