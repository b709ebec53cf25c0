"""Mamba2 / SSD mixer: chunked state-space dual scan + O(1) decode.

Port of `repro/models/ssm.py`. TP layout, as the reference's: inner
channels (heads x head_dim) shard over 'model'; the shared B/C state
projections (n_groups=1) replicate; the gated RMSNorm over the sharded
inner dim reduces its mean-square across TP through the engine (K1 on
the card).

Chunked SSD (paper Alg. 1 of arXiv:2405.21060): within a chunk the dual
quadratic form (an L x L decay-masked attention-like product); across
chunks a recurrence over (heads, state, head_dim) states — the
reference's `lax.scan`; on the card one fused kernel entry
(`kernels/csrc/ssd_scan.cu`, no (L, L, heads) tensor in device memory;
under autograd its backward differentiates the plain version), on the
CPU and on 'meta' the plain version's loop over the chunks
(`kernels/ref.py::ssd_chunked`). Decode carries (conv window,
ssm state): constant memory.

Activations are mesh-stacked (`parallel/ops.py`): (*mesh, B, S, ...).
The per-rank params (`a_log`, `dt_bias`, `d_skip`, the conv weights) are
stacked too, so every broadcast against them goes through `_trailing`;
the fp32 ones (`a_log`, `dt_bias`, `d_skip`) act in fp32 whatever dtype
they are handed in; the padded-channel mask is each rank's own, from
`ParCtx.tp_rank`.

A config with `ssm_conv_bias` (Granite-4.0-H) adds a bias to the causal
conv's channels, split as its weight is (`conv_x_b` sharded, `conv_bc_b`
replicated). While the wall-clock recorder records, the mixer is a span
`ssm.mixer` holding `ssm.proj` (the in-projection and the conv),
`ssm.scan` (the SSD scan or the decode step) and `ssm.norm` (the gated
norm and the out-projection).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry
from repro_torch.kernels import ops as kops
from repro_torch.models.common import Builder, _trailing, silu
from repro_torch.parallel.ops import ParCtx, local_matmul


def padded_ssm_heads(cfg: ArchConfig, tp: int) -> int:
    """SSM heads padded to a TP multiple (hymba: 50 -> 64 on tp=16).

    Padded channels are zero-masked before the gated norm, so they
    contribute nothing to outputs (see ssm_mixer)."""
    nh = cfg.ssm_n_heads
    return ((nh + tp - 1) // tp) * tp


def ssm_params(b: Builder, cfg: ArchConfig, tp: int):
    d = cfg.d_model
    nh = padded_ssm_heads(cfg, tp)
    di = nh * cfg.ssm_head_dim
    n = cfg.ssm_state
    cw = cfg.ssm_conv
    p = {
        # z and x projections are separate params: a concatenated (d, 2*di)
        # matrix sharded on dim1 would hand each TP rank a misaligned slice
        # spanning the z|x boundary.
        "w_z": b.param((d, di), ("data", "model")),
        "w_x": b.param((d, di), ("data", "model")),
        "w_bc": b.param((d, 2 * n), ("data", None)),
        "w_dt": b.param((d, nh), ("data", "model")),
        "conv_x": b.param((cw, di), (None, "model"), scale=0.5),
        "conv_bc": b.param((cw, 2 * n), (None, None), scale=0.5),
        "a_log": b.param((nh,), ("model",), init="ssm_a",
                         dtype=torch.float32),
        "dt_bias": b.param((nh,), ("model",), init="ssm_dt",
                           dtype=torch.float32),
        "d_skip": b.param((nh,), ("model",), init="ones",
                          dtype=torch.float32),
        "norm": b.param((di,), ("model",), init="ones"),
        "out_proj": b.param((di, d), ("model", "data")),
    }
    if cfg.ssm_conv_bias:
        p["conv_x_b"] = b.param((di,), ("model",), scale=0.1)
        p["conv_bc_b"] = b.param((2 * n,), (None,), scale=0.1)
    return p


def _causal_conv(x, w, state=None, bias=None):
    """Depthwise causal conv, width cw. x: (..., B, S, C); w: (cw, C) or
    stacked (*mesh, cw, C); `bias` (C,) or stacked (*mesh, C), added last.

    With `state` (..., B, cw-1, C) uses it as left context; returns
    (y, new_state) — new_state the last cw-1 inputs (the decode carry).
    The taps are summed in the reference's order, each product and each
    partial sum in x's dtype.
    """
    cw = w.shape[-2]
    s = x.shape[-2]
    if state is None:
        pad = x.new_zeros(tuple(x.shape[:-2]) + (cw - 1, x.shape[-1]))
        xp = torch.cat([pad, x], dim=-2)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=-2)
    y = 0
    for i in range(cw):
        y = y + xp[..., i:i + s, :] * _trailing(w[..., i, :], x.ndim).to(
            x.dtype)
    if bias is not None:
        y = y + _trailing(bias, x.ndim).to(x.dtype)
    new_state = xp[..., -(cw - 1):, :] if cw > 1 else None
    return y, new_state


def _ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk: int):
    """Chunked SSD scan (`kernels/ops.py::ssd_chunked`: the fused kernel
    on the card, the plain version `kernels/ref.py::ssd_chunked`
    elsewhere).

    xh: (N, S, H, P); dt: (N, S, H) (post-softplus); a_neg: (H,) or
    (N, H), negative; b_in, c_in: (N, S, n). Returns (y: (N, S, H, P) in
    xh's dtype, final state (N, H, n, P) fp32).
    """
    return kops.ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk)


def ssm_mixer(params, x, cfg: ArchConfig, ctx: ParCtx, conv_state=None,
              ssm_state=None, decode: bool = False):
    """`_mixer` under the span `ssm.mixer`."""
    tr = telemetry.wall()
    with tr.span("ssm.mixer", track="lm"):
        return _mixer(params, x, cfg, ctx, conv_state, ssm_state, decode, tr)


def _mixer(params, x, cfg: ArchConfig, ctx: ParCtx, conv_state, ssm_state,
           decode: bool, tr):
    """x: stacked (*mesh, B, S, D) -> the same. decode=True: S == 1 and
    the carries (conv_state (*mesh, B, cw-1, C_local), ssm_state (*mesh,
    B, H_local, n, P) fp32) are required.

    Returns (y, (new_conv_state, new_ssm_state)).
    """
    L = ctx.lead
    tp = ctx.tp
    nh_p = padded_ssm_heads(cfg, tp)
    di_p = nh_p * cfg.ssm_head_dim
    di_l = di_p // tp
    nh_l = nh_p // tp
    p = cfg.ssm_head_dim
    n = cfg.ssm_state

    with tr.span("ssm.proj", track="lm"):
        x = ctx.sp_allgather_seq(x) if not decode else x
        lead = tuple(x.shape[:L])
        # fused in-projection: one matmul for z | x | bc | dt
        w_z = ctx.gather_fsdp(params["w_z"])
        w_x = ctx.gather_fsdp(params["w_x"])
        w_bc = ctx.gather_fsdp(params["w_bc"])
        w_dt = ctx.gather_fsdp(params["w_dt"])
        w_in = torch.cat([w_z, w_x, w_bc, w_dt], dim=-1)
        zxbd = local_matmul(x, w_in.to(x.dtype), L)
        o1 = w_z.shape[-1]
        o2 = o1 + w_x.shape[-1]
        o3 = o2 + w_bc.shape[-1]
        z, xin, bc, dt_raw = (zxbd[..., :o1], zxbd[..., o1:o2],
                              zxbd[..., o2:o3], zxbd[..., o3:])

        conv_in = torch.cat([xin, bc], dim=-1)
        # conv weights: the x part is TP-local already (spec shards dim1); the
        # bc part replicated — the concat matches conv_in's channel layout
        wc = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
        bias = (torch.cat([params["conv_x_b"], params["conv_bc_b"]], dim=-1)
                if "conv_x_b" in params else None)
        conv_out, new_conv = _causal_conv(conv_in, wc, conv_state, bias)
        conv_out = silu(conv_out)
        xin = conv_out[..., :di_l]
        b_in = conv_out[..., di_l:di_l + n]
        c_in = conv_out[..., di_l + n:]

        # jax.nn.softplus is logaddexp(x, 0) (torch's softplus linearises
        # above a threshold)
        dtf = dt_raw.float() + _trailing(params["dt_bias"].float(),
                                         dt_raw.ndim)
        dt = torch.logaddexp(dtf, torch.zeros((), device=dtf.device))
        a_neg = -torch.exp(params["a_log"].float())           # (*mesh, nh_l)

    with tr.span("ssm.scan", track="lm"):
        bsz, s = xin.shape[L], xin.shape[L + 1]
        xh = xin.reshape(lead + (bsz, s, nh_l, p))

        if decode:
            a_step = torch.exp(dt[..., 0, :] * _trailing(a_neg, dt.ndim - 1))
            upd = torch.einsum("...bn,...bh,...bhp->...bhnp",
                               b_in[..., 0, :].float(), dt[..., 0, :],
                               xh[..., 0, :, :].float())
            new_ssm = a_step[..., None, None] * ssm_state + upd
            y = torch.einsum("...bn,...bhnp->...bhp", c_in[..., 0, :].float(),
                             new_ssm)[..., None, :, :]
        else:
            # fold the mesh and batch dims into one batch of sequences; each
            # rank's decay rates go with its own rows
            G = bsz * math.prod(lead)
            a_rows = a_neg.reshape(lead + (1, nh_l)).expand(
                lead + (bsz, nh_l)).reshape(G, nh_l)
            y, new_ssm = _ssd_chunked(
                xh.reshape((G, s, nh_l, p)), dt.reshape(G, s, nh_l), a_rows,
                b_in.reshape(G, s, n), c_in.reshape(G, s, n), cfg.ssm_chunk)
            y = y.reshape(lead + (bsz, s, nh_l, p))
            new_ssm = new_ssm.reshape(lead + (bsz, nh_l, n, p))

    with tr.span("ssm.norm", track="lm"):
        d_skip = params["d_skip"].float().reshape(
            tuple(params["d_skip"].shape[:-1]) + (1, 1, nh_l, 1))
        y = y + d_skip * xh.float()
        y = y.reshape(lead + (bsz, s, di_l)).to(x.dtype)
        y = y * silu(z)
        # zero padded channels (hymba: heads padded to a TP multiple) so they
        # never reach the norm statistics or the outputs
        ch = ctx.tp_rank(1) * di_l + torch.arange(di_l, device=y.device)
        live = ch < cfg.ssm_d_inner                           # (*mesh, di_l)
        y = y * _trailing(live, y.ndim).to(y.dtype)
        # gated RMSNorm over the REAL inner width (cross-TP mean-square)
        yf = y.float()
        ss = torch.sum(yf * yf, dim=-1, keepdim=True)
        if tp > 1:
            ss = ctx.engine.allreduce(ss, ctx.tp_axis)
        ms = ss / cfg.ssm_d_inner
        y = (yf * torch.rsqrt(ms + cfg.norm_eps)
             * _trailing(params["norm"], yf.ndim).float()).to(x.dtype)
        wo = ctx.gather_fsdp(params["out_proj"], dim=1)
        out = local_matmul(y, wo.to(y.dtype), L)
        if not decode:
            out = ctx.row_parallel_finish(out)
        elif tp > 1:
            out = ctx.engine.allreduce(out, ctx.tp_axis)
    return out, (new_conv, new_ssm)
