"""Config system: architecture + parallelism + run configs.

Copy of `repro/configs/base.py`, field for field (the port imports
nothing of the reference package, its jax-free modules included). Every
assigned architecture is an `ArchConfig` in its own module
(src/repro_torch/configs/<id>.py, copied from the reference's);
`get_config(name)` resolves them, and the port's own architectures
(`PORT_ARCH_IDS`, which no reference module has) beside them. The
parallelism knobs live in
`ParallelConfig`. The port serves and trains every family
(`models/serve.py`, `parallel/stages.py`); `remat`, `microbatches` and
`async_grad_sync` act as the reference's (`models/blocks.py`,
`parallel/stages.py`). `use_pallas` and `scan_layers` are kept for the
copy and have no effect in the port: on the card the port's kernels
always run and on the CPU their plain versions (`kernels/ops.py`); the
layers run in a Python loop (`models/blocks.py`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int             # dense-MLP hidden (0 = no dense MLP)
    vocab_size: int
    head_dim: int = 0     # 0 -> d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # attention variants
    sliding_window: int = 0          # 0 = full attention
    global_attn_layers: tuple = ()   # hybrid: layers that ignore the window
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (0 = decoder-only)
    encoder_layers: int = 0
    # multimodal prefix stub
    n_vis_tokens: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # source provenance (public literature), recorded for the report
    source: str = ""

    # The port's own knobs, fields of `LayerTypedConfig` alone (so the
    # ten reference configs stay field for field the reference's); here
    # their neutral values, which every family's code path reads.
    layer_types = ()
    shared_d_ff = 0
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    logits_scaling = 1.0
    attention_multiplier = 0.0
    use_rope = True
    ssm_conv_bias = False
    moe_dropless = False
    expert_init_fan_in = False
    q_lora_rank = 0
    kv_lora_rank = 0
    qk_nope_head_dim = 0
    qk_rope_head_dim = 0
    v_head_dim = 0
    yarn = ()
    router_scoring = "softmax"
    router_groups = 1
    router_topk_groups = 1
    routed_scaling = 1.0
    router_experts = 0
    expert_offset = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k decode: SSM state, hybrid, or SWA-bounded."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Parameter count (for MODEL_FLOPS = 6*N*D and memory budgets)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.resolved_head_dim
        per_layer = 0
        if self.has_attention:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.family == "moe":
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
        elif f:
            per_layer += 3 * d * f  # SwiGLU
        if self.family in ("ssm", "hybrid"):
            di, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
            ssm = d * (2 * di + 2 * st + nh)   # in_proj (z,x,B,C,dt)
            ssm += self.ssm_conv * (di + 2 * st)  # conv1d
            ssm += nh * 2                       # A_log, D
            ssm += di * d                       # out_proj
            per_layer += ssm
        per_layer += 2 * d  # norms
        emb = v * d if self.tie_embeddings else 2 * v * d
        total_layers = self.n_layers + self.encoder_layers
        if self.encoder_layers:  # cross-attention in decoder layers
            per_layer_x = 2 * d * self.n_kv_heads * hd + d * self.n_heads * hd \
                + self.n_heads * hd * d + d
            total = (self.n_layers * (per_layer + per_layer_x)
                     + self.encoder_layers * per_layer)
            return total + emb + 2 * d
        return total_layers * per_layer + emb + 2 * d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        dense = self.n_params()
        unused = (self.n_experts - self.experts_per_token) * \
            3 * self.d_model * self.moe_d_ff * self.n_layers
        return dense - unused


@dataclasses.dataclass(frozen=True)
class LayerTypedConfig(ArchConfig):
    """An architecture whose layers differ by kind, with Granite-4.0-H's
    knobs (`granitemoehybrid`; the port's own, no reference config has
    them). `models/blocks.py::layer_plan` reads the kinds.

    layer_types           per layer "mamba" (the Mamba2 mixer) or
                          "attention", each followed by the MoE; the
                          first `n_layers` entries are run
    shared_d_ff           width of the shared SwiGLU expert added to the
                          routed output (0: none)
    embedding_multiplier  scales the token embeddings
    residual_multiplier   scales both residual branches
    logits_scaling        divides the head's logits
    attention_multiplier  the softmax scale (0: 1 / sqrt(head_dim))
    use_rope              False: no positional embedding (NoPE)
    ssm_conv_bias         a bias on the causal conv's channels
    moe_dropless          size the dispatch by the per-expert counts, so
                          no assignment is dropped (the ten families keep
                          their capacity rule)
    expert_init_fan_in    draw each expert matrix by its fan-in (the
                          reference's law scales it by the expert count)

    DeepSeek-V3's knobs (`deepseek_v3`; layer types "mla_dense", MLA and
    the dense SwiGLU of `d_ff`, and "mla_moe", MLA and the MoE):

    q_lora_rank           MLA's query down-projection width
    kv_lora_rank          the latent `c_kv` width (0: no MLA)
    qk_nope_head_dim      a head's query / key width without rotation
    qk_rope_head_dim      the rotated width, shared by every head's key
    v_head_dim            a head's value width
    yarn                  MLA's YaRN rotary scaling (factor, original
                          max positions, beta_fast, beta_slow, mscale,
                          mscale_all_dim); () the plain frequencies
    router_scoring        "softmax" over the router's logits, or
                          "sigmoid" (each expert's own score, with a
                          correction bias for selection only: `noaux_tc`)
    router_groups         expert groups; each scored by the sum of its
                          two best biased scores
    router_topk_groups    the groups kept before the top-k
    routed_scaling        multiplies the (normalised) gates
    router_experts        the router's width, the published expert count
                          (0: `n_experts`); `n_experts` is then how many
                          this layer holds
    expert_offset         the first expert id held here: assignments to
                          the others add nothing and are counted
    """

    layer_types: tuple = ()
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0
    use_rope: bool = True
    ssm_conv_bias: bool = False
    moe_dropless: bool = False
    expert_init_fan_in: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    yarn: tuple = ()
    router_scoring: str = "softmax"
    router_groups: int = 1
    router_topk_groups: int = 1
    routed_scaling: float = 1.0
    router_experts: int = 0
    expert_offset: int = 0

    @property
    def kinds(self) -> tuple:
        return tuple(self.layer_types[:self.n_layers])

    def n_params(self) -> int:
        d, v, hd = self.d_model, self.vocab_size, self.resolved_head_dim
        di, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
        mamba = d * (2 * di + 2 * st + nh) + self.ssm_conv * (di + 2 * st) \
            + 2 * nh + di + di * d
        if self.ssm_conv_bias:
            mamba += di + 2 * st
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        if self.kv_lora_rank:
            attn = mla_params(self)
        ffn = d * (self.router_experts or self.n_experts) \
            + self.n_experts * 3 * d * self.moe_d_ff \
            + 3 * d * self.shared_d_ff + 2 * d
        if self.router_scoring == "sigmoid":      # the correction bias
            ffn += self.router_experts or self.n_experts
        dense = 3 * d * self.d_ff + 2 * d
        layers = sum((mamba if k == "mamba" else attn)
                     + (dense if k == "mla_dense" else ffn)
                     for k in self.kinds)
        emb = v * d if self.tie_embeddings else 2 * v * d
        return layers + emb + d

    def n_active_params(self) -> int:
        n_moe = sum(k != "mla_dense" for k in self.kinds)
        unused = (self.n_experts - self.experts_per_token) * 3 \
            * self.d_model * self.moe_d_ff * n_moe
        return self.n_params() - unused


def mla_params(cfg: ArchConfig) -> int:
    """One MLA mixer's parameters: the query down- and up-projections and
    their norm, the joint latent / rotated-key projection, the latent's
    norm, the per-head key and value up-projection, the out-projection."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return (d * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * h * qk
            + d * (r + cfg.qk_rope_head_dim) + r
            + r * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + h * cfg.v_head_dim * d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallelism & perf knobs (the hillclimb levers)."""

    backend: str = "microcode"         # 'microcode' | 'native'
    fsdp_axis: str = "data"            # weight-shard axis
    dp_axes: tuple = ("pod", "data")   # batch axes
    tp_axis: str = "model"
    sequence_parallel: bool = False    # SP norm regions (RS/AG pairs)
    remat: str = "full"                # 'none' | 'full' | 'dots'
    grad_compression: Optional[str] = None  # None | 'int8' | 'bf16'
    collective_matmul: bool = False    # streaming TP matmuls
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    moe_capacity_factor: float = 1.25
    use_pallas: bool = False
    scan_layers: bool = True
    # gradient accumulation: split the per-device batch into k microbatches
    # (scan with per-microbatch backward — activations shrink k x, enabling
    # remat='none' at full-remat memory budgets)
    microbatches: int = 1
    # decode: shard KV-cache sequence over the TP axis + flash-combine
    decode_seq_shard: bool = True
    # serving layout: params replicate over 'data' (no ZeRO-3 gathers on
    # the token path); set automatically by the serve step builders
    serving: bool = False
    # KV-cache storage dtype: 'param' (model dtype) or 'int8' (per-slot
    # symmetric quantization — the paper's unary streaming plugin applied
    # to cache storage; beyond-paper decode-memory optimization)
    kv_cache_dtype: str = "param"
    # gradient sync through the engine's request queue: every bucket's
    # allreduce is ISSUED non-blocking (engine.itree_allreduce) before
    # any is waited, so buckets across sync groups sit in the CCLO-style
    # command queue together — small same-dtype buckets coalesce and the
    # drain overlaps independent buckets' latency (bitwise-identical to
    # the blocking path by the queue's coalescing eligibility rule).
    async_grad_sync: bool = True


ASSIGNED_ARCHS = (
    "internvl2_26b", "mamba2_1p3b", "qwen3_14b", "smollm_360m",
    "qwen3_0p6b", "stablelm_12b", "mixtral_8x7b", "qwen3_moe_30b_a3b",
    "whisper_medium", "hymba_1p5b",
)

# CLI ids (--arch) use dashes/dots per the assignment table.
ARCH_IDS = {
    "internvl2-26b": "internvl2_26b",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-14b": "qwen3_14b",
    "smollm-360m": "smollm_360m",
    "qwen3-0.6b": "qwen3_0p6b",
    "stablelm-12b": "stablelm_12b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-medium": "whisper_medium",
    "hymba-1.5b": "hymba_1p5b",
}


# The port's own architectures (not in the reference's tables, which
# ARCH_IDS and ASSIGNED_ARCHS copy): CLI id -> module.
PORT_ARCH_IDS = {
    "granite-4.0-h-small": "granite_4p0_h_small",
    "deepseek-v3": "deepseek_v3",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ARCH_IDS.get(name) or PORT_ARCH_IDS.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test scale: same family/topology, tiny dimensions."""
    shrink = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        global_attn_layers=tuple(l for l in cfg.global_attn_layers if l < 2),
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_vis_tokens=4 if cfg.n_vis_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.layer_types:
        # one layer of each kind, in the order they first appear
        kinds = tuple(dict.fromkeys(cfg.kinds))
        shrink.update(n_layers=len(kinds), layer_types=kinds,
                      shared_d_ff=64 if cfg.shared_d_ff else 0)
    if cfg.kv_lora_rank:
        # MLA at tiny widths; the router over 8 experts in 4 groups, 2
        # kept, this layer holding all of them
        shrink.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, n_experts=8,
                      router_experts=8, router_groups=4,
                      router_topk_groups=2)
    shrink.update(overrides)
    return dataclasses.replace(cfg, **shrink)
