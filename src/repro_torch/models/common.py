"""Shared model machinery: param builder, norms, rope, activations.

Port of `repro/models/common.py`. One definition per param produces, by
mode,
  mode='init'   a real MESH-STACKED tensor over `mesh_shape`
                (leading dims the mesh axes in mesh order,
                trailing dims one rank's shard; `convert.py`), drawn from
                an explicit `torch.Generator` on an explicit device;
  mode='spec'   the param's PartitionSpec entries as a plain tuple;
  mode='shape'  an empty stacked tensor of the init shape and dtype on
                the 'meta' device (no storage; the reference's
                ShapeDtypeStruct).

Spec conventions are the reference's over the mesh (pod, data, model):
'data' in a spec is an FSDP shard, 'model' a tensor-parallel shard, and
an axis absent from a spec means the param is replicated over it.

Init laws are the reference's: "normal" is N(0, 1) * scale with a
default scale of 1/sqrt(shape[0]) (1 for a 1-D param), "zeros", "ones",
and the Mamba2 laws: "ssm_a" (A_log = log U(1, 16)) and "ssm_dt" (dt_bias
= softplus^-1 U(1e-3, 1e-1) = log expm1 U(1e-3, 1e-1)), both fp32.
A stacked param draws one shard per distinct position on the axes its
spec names and copies it over the axes it does not, so replicas are
equal; the draw is made in place on the device, so a large table is
never staged on the host. `spec_map`, when set, rewrites every spec
before it is used (the serving layout drops 'data', `parallel/stages.py`).

With `coords` set (one process's mesh position, `core/procgroup.py`)
'init' and 'shape' give that process's LOCAL shard alone, no mesh dims
leading (a layer-stacked leaf is then (L, *local), `models/blocks.py`).
Without a `generator`, each param's shard is drawn from its own
`torch.Generator`, seeded by (`seed`, the param's place in the
definition order, the shard's position on the axes its spec names), so
a process draws only its own slice — replicas still agree, and no
process draws the others' shards; these draws are not the stacked
mode's single stream. With a `generator`, a process draws each param
from the stacked mode's stream (one shard per distinct position, as
there) and keeps its own: its params are then bitwise the stacked
init's rows, at the cost of drawing every shard (one param at a time).

The numerics (`rms_norm`, `rope`, `silu`, `gelu`,
`sinusoidal_positions`) take mesh-stacked activations and act on their
trailing dims only, as the reference's act on one rank's local arrays; a
norm weight may be stacked (its leading dims the mesh's).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Optional

import torch

from repro_torch.parallel.ops import spec_axes


def local_shape(shape, spec, mesh_shape: dict) -> tuple:
    """One rank's shard shape of a global `shape` sharded by `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, spec):
        axes = spec_axes((entry,))
        parts = math.prod(mesh_shape[a] for a in axes)
        if dim % parts:
            raise ValueError(f"dim {dim} does not split over {axes}")
        out.append(dim // parts)
    return tuple(out)


@dataclasses.dataclass
class Builder:
    """One param definition -> stacked init tensor | spec tuple."""

    mode: str                      # 'init' | 'spec' | 'shape'
    generator: Optional[torch.Generator] = None
    mesh_shape: Optional[dict] = None     # needed in 'init' mode
    device: object = "cpu"
    dtype: torch.dtype = torch.float32
    spec_map: Optional[Callable] = None
    coords: Optional[dict] = None     # one process's place: local shards
    seed: int = 0                     # the per-process draws' seed
    _index: int = dataclasses.field(default=0, init=False, repr=False)

    def param(self, shape, spec, init: str = "normal",
              scale: Optional[float] = None, dtype=None):
        spec = tuple(spec)
        if self.spec_map is not None:
            spec = tuple(self.spec_map(spec))
        if self.mode == "spec":
            return spec
        if self.mode not in ("init", "shape"):
            raise ValueError(f"unknown Builder mode {self.mode!r}")
        dtype = dtype or self.dtype
        shape = tuple(shape)
        named = spec_axes(spec)
        local = local_shape(shape, spec, self.mesh_shape)
        gen = self.generator
        lead = tuple(self.mesh_shape.values())
        draw_lead = tuple(s if a in named else 1
                          for a, s in self.mesh_shape.items())
        pick = key = None
        if self.coords is not None:
            lead = ()
            if gen is None:
                draw_lead = ()
                key = (self.seed, self._index,
                       tuple(self.coords[a] for a in self.mesh_shape
                             if a in named))
                self._index += 1
            else:
                pick = tuple(self.coords[a] if a in named else 0
                             for a in self.mesh_shape)
        if self.mode == "shape":
            return torch.empty(lead + local, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(lead + local, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(lead + local, dtype=dtype, device=self.device)
        t = torch.empty(draw_lead + local, dtype=torch.float32,
                        device=self.device)
        if key is not None:
            gen = _shard_generator(key, self.device)
        if init == "normal":
            if scale is None:
                scale = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1.0)
            t.normal_(0.0, scale, generator=gen)
        elif init == "ssm_a":      # mamba A_log in [log 1, log 16]
            t = t.uniform_(1.0, 16.0, generator=gen).log_()
        elif init == "ssm_dt":     # dt bias ~ softplus^-1(U(1e-3, 1e-1))
            t = t.uniform_(1e-3, 1e-1, generator=gen).expm1_()
            t = t.log_()
        else:
            raise ValueError(init)
        if pick is not None:
            t = t[pick].clone()          # not a view of every shard's draw
        return t.to(dtype).expand(lead + local).contiguous()


def _shard_generator(key: tuple, device):
    """The generator of one param's shard in per-process mode, seeded
    from (seed, param index, shard position)."""
    digest = hashlib.sha256(repr(key).encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


# --------------------------------------------------------------------------
# Numerics
# --------------------------------------------------------------------------

def dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _trailing(w, ndim: int):
    """A stacked 1-D weight (*mesh, d) viewed to broadcast against an
    activation of `ndim` dims: (*mesh, 1, ..., 1, d)."""
    if w.ndim == 1:
        return w
    lead = tuple(w.shape[:-1])
    return w.reshape(lead + (1,) * (ndim - w.ndim) + (w.shape[-1],))


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last dim (the reference's TP-sharded variant,
    `psum_axis`, has no caller there: the SSM's gated norm reduces its own
    mean-square, `models/ssm.py`)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * _trailing(weight, x.ndim).float()).to(x.dtype)


def rope(x, positions, theta: float, yarn: tuple = (),
         interleave: bool = False):
    """Rotary embeddings. x: (..., S, H, hd); positions: (S,) (every rank
    holds the same positions). `yarn`: YaRN's scaled frequencies and
    cos / sin factor (`yarn_inv_freq`); `interleave`: x's rotated pairs
    are (2i, 2i + 1), taken apart into halves first (the published MLA
    code's `view(..., d / 2, 2).transpose`), so the result is in halves."""
    hd = x.shape[-1]
    half = hd // 2
    if yarn:
        freqs, m = yarn_inv_freq(hd, theta, *yarn)
        freqs = freqs.to(x.device)
    else:
        freqs = torch.exp(-math.log(theta)
                          * torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    angles = positions.to(x.device).float()[..., None] * freqs  # (S, half)
    cos = torch.cos(angles)[..., None, :]       # (S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    if yarn and m != 1.0:
        cos, sin = cos * m, sin * m
    if interleave:
        x = x.reshape(tuple(x.shape[:-1]) + (half, 2)).transpose(-1, -2) \
            .reshape(x.shape)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 0.1 mscale ln(factor) + 1 (1 unscaled)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float, mscale: float,
                  mscale_all_dim: float) -> tuple:
    """(the (dim / 2,) inverse frequencies, the cos / sin factor) of YaRN
    as the published DeepSeek code computes them: the plain frequencies
    above the correction range (rotations faster than `beta_fast` over
    the original context), the frequencies / factor below it (slower
    than `beta_slow`), a linear ramp between; the factor
    yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)."""
    def corr(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    lo = max(math.floor(corr(beta_fast)), 0)
    hi = min(math.ceil(corr(beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    inter = extra / factor
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - lo)
                       / (hi - lo), 0, 1)
    keep = 1.0 - ramp
    inv = inter * (1 - keep) + extra * keep
    return inv, yarn_mscale(factor, mscale) / yarn_mscale(factor,
                                                          mscale_all_dim)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def sinusoidal_positions(seq_len: int, d_model: int, offset=0,
                         device="cpu"):
    """Whisper-style absolute sinusoidal embeddings, computed on the fly."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
