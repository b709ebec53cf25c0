"""Operations that Granite-4.0-H's prefill needs, from the configuration
file's sizes alone (the published config's keys), for `granite_mfu`.

As `bench_counts` counts them: each multiply-add two operations, what
the work needs and not what an implementation does. A prompt of S
tokens, per layer:

  Mamba2     the in-projection (z, x, B, C, dt), the depthwise conv, the
             out-projection; the SSD chunked products: within a chunk
             C B^T and the decay-masked product with x dt at their causal
             half, each chunk's end state (B^T x dt) and its read-out
             (C h)
  attention  the q, k, v and o projections; q k^T and p v at their causal
             half
  MoE        the router, the routed experts at top-k (every token's k
             experts, not the dispatch's padded capacity), the shared
             expert
  head       the last position's logits alone (2 d V)
"""
from __future__ import annotations


def _causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal n x n product, the diagonal in."""
    return n * (n + 1) // 2


def mamba_flops(cfg: dict, s: int) -> int:
    d, h, p = cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, cw, l = cfg["mamba_d_state"], cfg["mamba_d_conv"], \
        cfg["mamba_chunk_size"]
    di = h * p
    proj = 2 * s * d * (2 * di + 2 * n + h) + 2 * s * di * d
    conv = 2 * s * cw * (di + 2 * n)
    chunks, tail = divmod(s, l)
    pairs = chunks * _causal_pairs(l) + _causal_pairs(tail)
    ssd = 2 * pairs * n + 2 * pairs * h * p + 2 * 2 * s * h * n * p
    return proj + conv + ssd


def attention_flops(cfg: dict, s: int) -> int:
    d, nh, kv = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = d // nh
    proj = 2 * s * d * (nh + 2 * kv) * hd + 2 * s * nh * hd * d
    return proj + 2 * 2 * nh * hd * _causal_pairs(s)


def moe_flops(cfg: dict, s: int) -> int:
    d, e, k = cfg["hidden_size"], cfg["num_local_experts"], \
        cfg["num_experts_per_tok"]
    return 2 * s * d * e + 2 * s * k * 3 * d * cfg["intermediate_size"] \
        + 2 * s * 3 * d * cfg["shared_intermediate_size"]


def prefill_flops(cfg: dict, s: int) -> int:
    """One prompt of `s` tokens through the configuration's layers and
    the head at its last position."""
    types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    layers = sum((mamba_flops(cfg, s) if t == "mamba"
                  else attention_flops(cfg, s)) + moe_flops(cfg, s)
                 for t in types)
    return layers + 2 * cfg["hidden_size"] * cfg["vocab_size"]
