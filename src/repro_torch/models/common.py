"""Shared model machinery: the param builder.

Port of `repro/models/common.py::Builder`. One definition per param
produces, by mode,
  mode='init'   a real MESH-STACKED tensor over `mesh_shape`
                (leading dims the mesh axes in mesh order,
                trailing dims one rank's shard; `convert.py`), drawn from
                an explicit `torch.Generator` on an explicit device;
  mode='spec'   the param's PartitionSpec entries as a plain tuple.

Spec conventions are the reference's over the mesh (pod, data, model):
'data' in a spec is an FSDP shard, 'model' a tensor-parallel shard, and
an axis absent from a spec means the param is replicated over it.

Init laws are the reference's: "normal" is N(0, 1) * scale with a
default scale of 1/sqrt(shape[0]) (1 for a 1-D param), and "zeros"
(the reference's other laws serve the LM stack). A stacked param draws one shard per distinct position on the
axes its spec names and copies it over the axes it does not, so replicas
are equal; the draw is made in place on the device, so a large table is
never staged on the host. Norms, rope and the rest wait for the LM
stack.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

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

    mode: str                      # 'init' | 'spec'
    generator: Optional[torch.Generator] = None
    mesh_shape: Optional[dict] = None     # needed in 'init' mode
    device: object = "cpu"
    dtype: torch.dtype = torch.float32

    def param(self, shape, spec, init: str = "normal",
              scale: Optional[float] = None, dtype=None):
        spec = tuple(spec)
        if self.mode == "spec":
            return spec
        if self.mode != "init":
            raise ValueError(f"unknown Builder mode {self.mode!r}")
        dtype = dtype or self.dtype
        shape = tuple(shape)
        named = spec_axes(spec)
        lead = tuple(self.mesh_shape.values())
        draw_lead = tuple(s if a in named else 1
                          for a, s in self.mesh_shape.items())
        local = local_shape(shape, spec, self.mesh_shape)
        if init == "zeros":
            return torch.zeros(lead + local, dtype=dtype, device=self.device)
        if init != "normal":
            raise ValueError(init)
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1.0)
        t = torch.empty(draw_lead + local, dtype=torch.float32,
                        device=self.device)
        t.normal_(0.0, scale, generator=self.generator)
        return t.to(dtype).expand(lead + local).contiguous()
