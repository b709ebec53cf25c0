"""Plain reference of Granite-4.0-H's forward (`granitemoehybrid`), one
sequence, float32, plain PyTorch.

It follows the published modelling code layer for layer:

    x = embed[tokens] * embedding_multiplier
    for each layer (layer_types[i]):
        x = x + residual_multiplier * mixer(rmsnorm(x))
        h = rmsnorm(x)
        x = x + residual_multiplier * (moe(h) + shared(h))
    logits = rmsnorm(x) @ embed^T / logits_scaling

with the Mamba2 mixer (in-projection to z | x | B | C | dt, a depthwise
causal conv with bias over x | B | C and SiLU, dt = softplus(dt +
dt_bias), the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
y_t = C_t h_t + D x_t, then y * silu(z), an RMSNorm over the whole inner
width (one group) and the out-projection) or NoPE attention (GQA, no
positional embedding, softmax scale `attention_multiplier`, causal); the
MoE routes each token to the `num_experts_per_tok` largest router logits,
weighted by the softmax over those logits, every expert a SwiGLU, and
drops nothing (a loop over the experts); the shared expert is a SwiGLU
too. The SSD runs in the Mamba2 paper's minimal chunked form (chunks of
`mamba_chunk_size`, a sequence zero-padded to a whole chunk: a padded
step has dt = 0, so it changes no state). Every product is float32, with
TF32 off (a float32 product in TF32 would be a lower precision than the
reference states).

Departures from the published model: none in the mathematics. Weights
are given, not loaded: `layer_of(i)` returns layer i's tensors (any
dtype or device; each is taken to float32 on `device` as it is used, one
layer at a time, so the model never sits whole in float32), named as
the port names them (`w_z`, `w_x`, `w_bc` = [B | C], `w_dt`, `conv_x`,
`conv_bc` (width x channels), `conv_x_b`, `conv_bc_b`, `a_log`,
`dt_bias`, `d_skip`, `norm`, `out_proj`; `wq`, `wk`, `wv`, `wo`;
`router` (d, E), expert `w1` / `w3` (E, d, f), `w2` (E, f, d); the shared
expert's `w1` / `w3` (d, f), `w2` (f, d)), every matrix as x @ w.
It imports nothing of the program.

`round_inputs` rounds every product's operands first (the control: the
reference in a precision below the configuration's).

Routing near-ties: the program computes in bfloat16, and where a token's
router logits at ranks k and k + 1 lie closer than its rounding moves
them, the program's k-th expert may be the reference's (k + 1)-th. With
`routes` (the program's own top-k ids, one (S, k) tensor an MoE layer)
and a `margin`, a token whose reference logits at ranks k and k + 1 lie
within `margin` of each other takes the program's experts, weighted by
the softmax of the reference's own logits at them; every other token
keeps the reference's choice. `stats` counts the tokens routed so
(`near_ties`, each one whose experts differ from the reference's), the
routed tokens (`routed`) and the widest rank-k gap among the tokens
whose program experts differ from the reference's (`swap_gap`, whether
within the margin or not).
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


def _segsum(x):
    """exp-ready segment sums: out[..., i, j] = sum x[..., j+1..i] for
    j <= i, -inf above the diagonal (the Mamba2 paper's `segsum`)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, float("-inf"))


def ssd(ops: _Ops, xdt, adt, b, c, chunk: int, heads: int = 16):
    """The minimal chunked SSD (one sequence, one group): xdt (S, H, P) =
    x dt, adt (S, H) = A dt, b / c (S, n). Returns y (S, H, P) and the
    final state (H, n, P). Heads are independent: `heads` of them at a
    time, so the (heads, chunks, l, l) decay masks stay small."""
    s, h, p = xdt.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        xdt = torch.cat([xdt, xdt.new_zeros(pad, h, p)])
        adt = torch.cat([adt, adt.new_zeros(pad, h)])
        b = torch.cat([b, b.new_zeros(pad, n)])
        c = torch.cat([c, c.new_zeros(pad, n)])
    nc = xdt.shape[0] // chunk
    B = b.reshape(nc, chunk, n)
    C = c.reshape(nc, chunk, n)
    scores = ops.ein("cln,csn->cls", C, B)
    ys, finals = [], []
    for lo in range(0, h, heads):
        X = xdt[:, lo:lo + heads].reshape(nc, chunk, -1, p)
        A = adt[:, lo:lo + heads].reshape(nc, chunk, -1).permute(2, 0, 1)
        hb = A.shape[0]
        a_cum = torch.cumsum(A, dim=-1)                     # (hb, c, l)
        # within each chunk: the decay-masked quadratic form
        L = torch.exp(_segsum(A))                            # (hb, c, l, s)
        y_diag = ops.ein("hcls,cshp->clhp", L * scores[None], X)
        del L
        # each chunk's end state, then the recurrence across chunks
        decay = torch.exp(a_cum[..., -1:] - a_cum)          # (hb, c, l)
        states = ops.ein("cln,hcl,clhp->chnp", B, decay, X)
        states = torch.cat([states.new_zeros(1, hb, n, p), states])
        last = torch.nn.functional.pad(a_cum[..., -1], (1, 0))
        carry = torch.exp(_segsum(last))                     # (hb, c+1, c+1)
        new = ops.ein("hzc,chnp->zhnp", carry, states)
        states, final = new[:-1], new[-1]
        y_off = ops.ein("cln,chnp,hcl->clhp", C, states, torch.exp(a_cum))
        ys.append((y_diag + y_off).reshape(nc * chunk, hb, p))
        finals.append(final)
    return torch.cat(ys, dim=1)[:s], torch.cat(finals)


def mamba(ops: _Ops, w, x, cfg: dict):
    """The Mamba2 mixer over x (S, d). Returns (y (S, d), (conv state
    (cw - 1, di + 2n): the last inputs of the conv, ssm state (H, n,
    P)))."""
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, cw = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    di = h * p
    s = x.shape[0]
    z = ops.mm(x, w["w_z"])
    xbc = torch.cat([ops.mm(x, w["w_x"]), ops.mm(x, w["w_bc"])], dim=-1)
    dt = ops.mm(x, w["w_dt"])
    conv_w = torch.cat([w["conv_x"], w["conv_bc"]], dim=-1)  # (cw, C)
    conv_b = torch.cat([w["conv_x_b"], w["conv_bc_b"]])
    xp = torch.cat([xbc.new_zeros(cw - 1, xbc.shape[1]), xbc])
    conv = conv_b + sum(xp[i:i + s] * conv_w[i] for i in range(cw))
    conv_state = xp[-(cw - 1):]
    conv = silu(conv)
    xs, b, c = conv[:, :di], conv[:, di:di + n], conv[:, di + n:]
    dt = torch.logaddexp(dt + w["dt_bias"], torch.zeros((), device=x.device))
    a = -torch.exp(w["a_log"])
    xh = xs.reshape(s, h, p)
    y, state = ssd(ops, xh * dt[..., None], dt * a, b, c,
                   cfg["mamba_chunk_size"])
    y = y + w["d_skip"][:, None] * xh
    y = y.reshape(s, di) * silu(z)
    y = rmsnorm(y, w["norm"], cfg["rms_norm_eps"])
    return ops.mm(y, w["out_proj"]), (conv_state, state)


def attention(ops: _Ops, w, x, cfg: dict, q_block: int = 1024):
    """Causal NoPE GQA over x (S, d). Returns (y (S, d), (k, v) (S, KV,
    hd))."""
    nh, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    s = x.shape[0]
    q = ops.mm(x, w["wq"]).reshape(s, nh, hd)
    k = ops.mm(x, w["wk"]).reshape(s, kv, hd)
    v = ops.mm(x, w["wv"]).reshape(s, kv, hd)
    kr = k.repeat_interleave(nh // kv, dim=1)
    vr = v.repeat_interleave(nh // kv, dim=1)
    out = torch.empty_like(q)
    pos = torch.arange(s, device=x.device)
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        sc = ops.ein("qhd,khd->hqk", q[lo:hi], kr[:hi]) \
            * cfg["attention_multiplier"]
        sc = sc.masked_fill(pos[None, lo:hi, None] < pos[None, None, :hi],
                            float("-inf"))
        out[lo:hi] = ops.ein("hqk,khd->qhd", torch.softmax(sc, dim=-1),
                             vr[:hi])
    return ops.mm(out.reshape(s, nh * hd), w["wo"]), (k, v)


def moe(ops: _Ops, w, x, cfg: dict, route=None, margin: float = 0.0,
        stats=None, chosen=None):
    """The routed experts over x (S, d), dropless: each expert's tokens
    in turn. `route`: the program's (S, k) experts, taken where the
    reference's rank-k and rank-(k + 1) logits lie within `margin`;
    `chosen`: a list the (S, k) experts taken are appended to."""
    k = cfg["num_experts_per_tok"]
    logits = ops.mm(x, w["router"])
    top, idx = torch.topk(logits, k + 1, dim=-1)
    idx = idx[:, :k]
    if route is not None:
        route = route.to(idx.device).long()
        differ = (torch.sort(route, -1).values
                  != torch.sort(idx, -1).values).any(-1)
        gap = top[:, k - 1] - top[:, k]
        take = differ & (gap < margin)
        idx = torch.where(take[:, None], route, idx)
        if stats is not None:
            stats["near_ties"] = stats.get("near_ties", 0) + int(take.sum())
            stats["routed"] = stats.get("routed", 0) + x.shape[0]
            widest = float(gap[differ].max()) if bool(differ.any()) else 0.0
            stats["swap_gap"] = max(stats.get("swap_gap", 0.0), widest)
    gates = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
    if chosen is not None:
        chosen.append(idx)
    out = torch.zeros_like(x)
    for e in range(w["w1"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu(ops, x[tok], w["w1"][e], w["w3"][e], w["w2"][e])
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


def _f32(tree, device):
    if isinstance(tree, dict):
        return {k: _f32(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32)


def forward(layer_of, embed, final_norm, tokens, cfg: dict, *,
            last: int = 1, round_inputs=None, routes=None,
            margin: float = 0.0, stats=None, chosen=None):
    """tokens (S,) -> (the logits of the last `last` positions (last, V)
    float32, each layer's caches: (k, v) for attention, (conv, state)
    for Mamba). `layer_of(i)`: layer i's tensors; `embed` (V, d),
    `final_norm` (d,); the config's keys are the published config's.
    `routes` / `margin` / `stats` / `chosen`: the routing near-ties
    (`moe`)."""
    _no_tf32()
    ops = _Ops(round_inputs)
    dev = tokens.device
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    emb = embed.to(device=dev, dtype=torch.float32)
    x = emb[tokens.long()] * cfg["embedding_multiplier"]
    caches = []
    types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    for i, kind in enumerate(types):
        w = _f32(layer_of(i), dev)
        h = rmsnorm(x, w["norm1"], eps)
        if kind == "mamba":
            y, cache = mamba(ops, w["ssm"], h, cfg)
        else:
            y, cache = attention(ops, w["attn"], h, cfg)
        x = x + rm * y
        h = rmsnorm(x, w["norm2"], eps)
        sh = w["shared"]
        route = routes[i] if routes is not None else None
        x = x + rm * (moe(ops, w["moe"], h, cfg, route, margin, stats,
                          chosen)
                      + swiglu(ops, h, sh["w1"], sh["w3"], sh["w2"]))
        caches.append(cache)
        del w, h, y
    x = rmsnorm(x[-last:], final_norm.to(device=dev, dtype=torch.float32),
                eps)
    return ops.mm(x, emb.t()) / cfg["logits_scaling"], caches


def gap(got, want) -> float:
    """The widest error against the reference as a share of the
    reference's root mean square; inf where `got` holds a non-number."""
    want = want.double()
    err = (got.double() - want).abs()
    if not bool(torch.isfinite(err).all()):
        return float("inf")
    rms = float(want.pow(2).mean().sqrt())
    return float(err.max()) / max(rms, 1e-300)
