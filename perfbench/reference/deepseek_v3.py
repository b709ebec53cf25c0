"""Plain reference of DeepSeek-V3's forward (`deepseek_v3`), one sequence,
float32, plain PyTorch.

It follows the published modelling code layer for layer:

    x = embed[tokens]
    for each layer i:
        x = x + mla(rmsnorm(x))
        h = rmsnorm(x)
        x = x + (swiglu(h)            if i < first_k_dense_replace
                 else moe(h) + shared(h))
    logits = rmsnorm(x) @ head^T

MLA: q = rmsnorm(x W_qa) W_qb, per head [q_nope (128) | q_pe (64)]; x
W_kva = [c (512) | k_pe (64)], c_kv = rmsnorm(c); per head [k_nope | v] =
c_kv W_kvb; q_pe and k_pe (one, every head's) rotated by YaRN's
frequencies, the pairs interleaved (the published `view(..., d / 2,
2).transpose(4, 3)` before `rotate_half`); softmax scale m^2 /
sqrt(192), m = 0.1 mscale_all_dim ln(factor) + 1; causal. The MoE: s =
sigmoid(h W_r) over the router's published width; the selection reads s
+ b (the correction bias): each of `n_group` groups scores the sum of its
two best, the `topk_group` best groups are kept and the top
`num_experts_per_tok` of s + b among their experts chosen (the others
at -inf, as the published inference code masks them); the gates are s
at the chosen experts normalised to sum 1, times
`routed_scaling_factor`. Every expert and the shared expert a SwiGLU.
Every product is float32, with TF32 off (a float32 product in TF32 would
be a lower precision than the reference states); attention runs in
blocks of queries and heads so that the scores fit.

The expert share: the layer holds `n_routed_experts` of the router's
`router_experts` (from `held_experts_from`); an assignment to an expert
held elsewhere adds nothing (the partial result of this share goes on,
as in the program). With the whole width held it is the published layer.

Departures from the published model: the multi-token prediction layer
(`num_nextn_predict_layers`) is not run, as a first-token prefill never
runs it; the weights are given in the configuration's dtype (bfloat16),
not the published FP8 with 128 x 128 block scales. Weights are given,
not loaded: `layer_of(i)` returns layer i's tensors (any dtype or
device; each is taken to float32 on `device` as it is used, one layer,
and of the experts one expert, at a time), named as the port names them
(`attn`: `wq_a`, `q_a_norm`, `wq_b`, `wkv_a`, `kv_a_norm`, `wkv_b`, `wo`;
`mlp` / `shared`: `w1`, `w3`, `w2`; `moe`: `router` (d, E), `router_bias`
(E,), expert `w1` / `w3` (E_held, d, f), `w2` (E_held, f, d); `norm1`,
`norm2`), every matrix as x @ w. It imports nothing of the program.

`round_inputs` rounds every product's operands first (the control: the
reference in a precision below the configuration's).

Routing near-ties: the program computes in bfloat16, and where a token's
group scores at ranks `topk_group` and `topk_group` + 1, or its biased
scores at ranks k and k + 1 among the kept groups, lie closer than its
rounding moves them, the program's selection may differ from the
reference's. With `routes` (the program's own top-k ids, one (S, k)
tensor an MoE layer) every token takes the program's experts, gated by
the reference's own scores at them, so that the answers compare the
arithmetic of one routing and no single swapped token decides them.
`stats` counts the tokens whose experts differ (`near_ties`), the routed
tokens (`routed`) and the widest of the reference's own routing gaps
(the smaller of the two above) among those tokens (`swap_gap`): a swap
the program's rounding explains lies within a few hundredths, a routing
fault further out.
"""
from __future__ import annotations

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t):
    """A tensor rounded through float8_e4m3fn (saturated at its largest
    value, 448) and back to float32."""
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


class _Ops:
    """The products, each operand rounded by `rnd` first (or not)."""

    def __init__(self, rnd=None):
        self.rnd = rnd or (lambda t: t)

    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)

    def ein(self, eq, *ts):
        return torch.einsum(eq, *[self.rnd(t) for t in ts])


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def silu(x):
    return x * torch.sigmoid(x)


def swiglu(ops: _Ops, x, w1, w3, w2):
    return ops.mm(silu(ops.mm(x, w1)) * ops.mm(x, w3), w2)


# --------------------------------------------------------------------------
# YaRN
# --------------------------------------------------------------------------

def _ln(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float64).log())


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * _ln(scale) + 1.0


def yarn_inv_freq(dim: int, cfg: dict) -> tuple:
    """(inverse frequencies (dim / 2,), the cos / sin factor), as the
    published `DeepseekV3YarnRotaryEmbedding` computes them."""
    rs, base = cfg["rope_scaling"], float(cfg["rope_theta"])
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return (dim * _ln(orig / (rot * 2 * torch.pi))) / (2 * _ln(base))
    low = max(int(corr_dim(rs["beta_fast"]) // 1), 0)
    high = min(-int(-corr_dim(rs["beta_slow"]) // 1), dim - 1)
    if low == high:
        high += 0.001
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** pos)
    freq_inter = 1.0 / (factor * base ** pos)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv = freq_inter * (1 - mask) + freq_extra * mask
    m = yarn_get_mscale(factor, rs["mscale"]) \
        / yarn_get_mscale(factor, rs["mscale_all_dim"])
    return inv, m


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_get_mscale(float(rs["factor"]), rs["mscale_all_dim"])
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return qk ** -0.5 * m * m


def rotate(x, cos, sin):
    """x (S, H, d) in interleaved pairs -> rotated, in halves (the
    published `apply_rotary_pos_emb`)."""
    s, h, d = x.shape
    x = x.reshape(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def rope_tables(s: int, cfg: dict, device) -> tuple:
    inv, m = yarn_inv_freq(cfg["qk_rope_head_dim"], cfg)
    t = torch.arange(s, dtype=torch.float32)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def mla(ops: _Ops, w, x, cfg: dict, tables, q_block: int = 512,
        heads: int = 32):
    """Causal MLA over x (S, d). Returns (y (S, d), (c_kv (S, r), k_pe (S,
    rope)))."""
    nh = cfg["num_attention_heads"]
    nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    v_d, r, eps = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    s = x.shape[0]
    cos, sin = tables
    q = ops.mm(rmsnorm(ops.mm(x, w["wq_a"]), w["q_a_norm"], eps), w["wq_b"])
    q = q.reshape(s, nh, nope + rope_d)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], dim=-1)
    kv_a = ops.mm(x, w["wkv_a"])
    c_kv = rmsnorm(kv_a[:, :r], w["kv_a_norm"], eps)
    k_pe = rotate(kv_a[:, None, r:], cos, sin)            # (S, 1, rope)
    kv = ops.mm(c_kv, w["wkv_b"]).reshape(s, nh, nope + v_d)
    k = torch.cat([kv[..., :nope], k_pe.expand(s, nh, rope_d)], dim=-1)
    v = kv[..., nope:]
    del kv
    scale = softmax_scale(cfg)
    out = torch.empty(s, nh, v_d, device=x.device)
    pos = torch.arange(s, device=x.device)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        future = pos[lo:hi, None] < pos[None, :hi]
        for h0 in range(0, nh, heads):
            h1 = min(nh, h0 + heads)
            sc = ops.ein("qhd,khd->hqk", q[lo:hi, h0:h1], k[:hi, h0:h1]) \
                * scale
            sc = sc.masked_fill(future[None], float("-inf"))
            out[lo:hi, h0:h1] = ops.ein("hqk,khd->qhd",
                                        torch.softmax(sc, dim=-1),
                                        v[:hi, h0:h1])
            del sc
    y = ops.mm(out.reshape(s, nh * v_d), w["wo"])
    return y, (c_kv, k_pe[:, 0])


# --------------------------------------------------------------------------
# The MoE
# --------------------------------------------------------------------------

def gate(scores, bias, cfg: dict) -> tuple:
    """(the chosen experts (S, k), the biased scores' smaller gap at the
    group cut and the k-th expert (S,)): `noaux_tc` over the sigmoid
    scores (S, E)."""
    k, ng, kg = cfg["num_experts_per_tok"], cfg["n_group"], cfg["topk_group"]
    s = scores.shape[0]
    biased = scores + bias
    grouped = biased.reshape(s, ng, -1)
    group_scores = grouped.topk(2, dim=-1)[0].sum(-1)        # (S, ng)
    gs, gi = group_scores.sort(-1, descending=True)
    kept = torch.zeros(s, ng, dtype=torch.bool, device=scores.device)
    kept.scatter_(1, gi[:, :kg], True)
    masked = grouped.masked_fill(~kept[..., None], float("-inf")) \
        .reshape(s, -1)
    top, idx = masked.topk(k + 1, dim=-1)
    gap = torch.minimum(gs[:, kg - 1] - gs[:, kg], top[:, k - 1] - top[:, k])
    return idx[:, :k], gap


def moe(ops: _Ops, w, x, cfg: dict, route=None, stats=None, chosen=None):
    """The routed experts held here over x (S, d), dropless: each held
    expert's tokens in turn. `route`: the program's (S, k) experts, taken
    in place of the reference's own; `chosen`: a list the (S, k) experts
    taken are appended to."""
    scores = torch.sigmoid(ops.mm(x, w["router"]))
    idx, gap = gate(scores, w["router_bias"], cfg)
    if route is not None:
        route = route.to(idx.device).long()
        differ = (torch.sort(route, -1).values
                  != torch.sort(idx, -1).values).any(-1)
        idx = torch.where(differ[:, None], route, idx)
        if stats is not None:
            stats["near_ties"] = stats.get("near_ties", 0) + int(differ.sum())
            stats["routed"] = stats.get("routed", 0) + x.shape[0]
            widest = float(gap[differ].max()) if bool(differ.any()) else 0.0
            stats["swap_gap"] = max(stats.get("swap_gap", 0.0), widest)
    g = torch.gather(scores, 1, idx)
    g = g / g.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    if chosen is not None:
        chosen.append(idx)
    out = torch.zeros_like(x)
    lo = cfg["held_experts_from"]
    for e in range(w["w1"].shape[0]):
        tok, slot = torch.nonzero(idx == lo + e, as_tuple=True)
        if tok.numel():
            y = swiglu(ops, x[tok], w["w1"][e].to(x), w["w3"][e].to(x),
                       w["w2"][e].to(x))
            out.index_add_(0, tok, y * g[tok, slot, None])
    return out


def _f32(tree, device):
    """Every tensor to float32 on `device`, but the expert stacks (taken
    one expert at a time as they are used)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _f32(v, device) if k != "moe" else {
                n: (t.to(device) if n in ("w1", "w3", "w2") else
                    t.to(device=device, dtype=torch.float32))
                for n, t in v.items()}
        else:
            out[k] = v.to(device=device, dtype=torch.float32)
    return out


def forward(layer_of, embed, head, final_norm, tokens, cfg: dict, *,
            last: int = 1, round_inputs=None, routes=None,
            stats=None, chosen=None):
    """tokens (S,) -> (the logits of the last `last` positions (last, V)
    float32, each layer's latent cache (c_kv (S, r), k_pe (S, rope))).
    `layer_of(i)`: layer i's tensors; `embed`, `head` (V, d), `final_norm`
    (d,); the config's keys are the published config's. `routes` /
    `stats` / `chosen`: the routing near-ties (`moe`), one entry an MoE
    layer."""
    _no_tf32()
    ops = _Ops(round_inputs)
    dev = tokens.device
    eps = cfg["rms_norm_eps"]
    x = embed[tokens.long()].to(device=dev, dtype=torch.float32)
    tables = rope_tables(tokens.shape[0], cfg, dev)
    caches = []
    dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        w = _f32(layer_of(i), dev)
        y, cache = mla(ops, w["attn"], rmsnorm(x, w["norm1"], eps), cfg,
                       tables)
        x = x + y
        h = rmsnorm(x, w["norm2"], eps)
        if i < dense:
            m = w["mlp"]
            x = x + swiglu(ops, h, m["w1"], m["w3"], m["w2"])
        else:
            sh = w["shared"]
            route = routes[i - dense] if routes is not None else None
            x = x + moe(ops, w["moe"], h, cfg, route, stats, chosen) \
                + swiglu(ops, h, sh["w1"], sh["w3"], sh["w2"])
        caches.append(cache)
        del w, h, y
    x = rmsnorm(x[-last:], final_norm.to(device=dev, dtype=torch.float32),
                eps)
    return ops.mm(x, head.to(device=dev, dtype=torch.float32).t()), caches


def gap(got, want) -> float:
    """The widest error against the reference as a share of the
    reference's root mean square; inf where `got` holds a non-number."""
    want = want.double()
    err = (got.double() - want).abs()
    if not bool(torch.isfinite(err).all()):
        return float("inf")
    rms = float(want.pow(2).mean().sqrt())
    return float(err.max()) / max(rms, 1e-300)


def rms_gap(got, want) -> float:
    """The error's root mean square as a share of the reference's: an
    error spread over every token, where `gap` reads the widest one; inf
    where `got` holds a non-number."""
    want = want.double()
    err = got.double() - want
    if not bool(torch.isfinite(err).all()):
        return float("inf")
    return float(err.pow(2).mean().sqrt()) / max(
        float(want.pow(2).mean().sqrt()), 1e-300)
