"""Serving session: prefill -> decode cache handoff.

Port of `repro/runtime/serve_session.py`. prefill emits layer-stacked
caches in a uniform full-prompt-length layout; decode wants per-layer
caches at s_max with SWA windows rolled. The conversion works on GLOBAL
views of the caches, as the reference's does, but on the caches' own
device: each layer's stacked prefill cache is unstacked
(`convert.unstack`), rearranged, and stacked again with the decode
layout (`convert.stack_global`) — no trip through the host.

The SSM carries and the audio family's cross cache come out of prefill
in decode's own layout and carry over as they are. As the reference's,
the session prefills tokens only and builds decode without an encoder
cache, so it serves every family but audio (whose prefill needs
`frames`): that family is served through `stages.build_prefill`, this
module's `convert_prefill_caches(..., s_enc=...)` and
`stages.build_decode_step(..., s_enc=...)` (ROADMAP Queue 3).

On a `ProcessGroupEngine` (one rank per process) the session takes the
engine and works on this process's local shards: a global batch is cut
to its rows (`convert.shard_of`), each prefill cache is gathered along
every dim but the batch's through the engine (`convert.gather_global`:
the prompt's sequence shards and the decode cache's fall on different
ranks), rearranged, and cut to the decode layout's shard; the generated
tokens are gathered the same way, so every process returns the whole.

With `kv_cache_dtype="int8"` (which the reference's session refuses)
the handoff quantizes each prompt slot with the decode write's own
quantizer (`serve.quantize_kv`), so the decode caches hold what a decode
that had written those slots would hold.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.convert import gather_global, shard_of, stack_global, \
    unstack
from repro_torch.models.blocks import window_per_layer
from repro_torch.models.serve import (
    layer_cache_len, prefill_cache_names, prefill_cache_rows,
    prefill_cache_specs, quantize_kv,
)
from repro_torch.parallel import stages


def convert_prefill_caches(prefill_caches, cfg: ArchConfig,
                           pcfg: ParallelConfig, mesh_shape: dict, tp: int,
                           batch: int, s_prompt: int, s_max: int,
                           s_enc: int = 0, engine=None):
    """Rearrange prefill's layer-stacked caches into decode's per-layer
    layout (int8 with its scales when pcfg.kv_cache_dtype says so). Per
    layer (`serve.prefill_cache_rows`: a layer-typed stack emits each
    name over the layers that hold it), as the reference's: the attention
    k/v are placed at s_max (SWA windows rolled), and so is MLA's latent
    pair `c_kv`/`k_pe`; the SSM `conv`/`state` and the audio cross cache
    `xk`/`xv` carry over as they are (prefill emits them in decode's
    layout). With a per-process `engine`, the caches are this
    process's local shards, and so is the result."""
    windows = window_per_layer(cfg, cfg.n_layers)
    dp = stages.dp_axes(mesh_shape, batch)
    decode_specs = stages.cache_specs(cfg, pcfg, tp, s_max, s_enc=s_enc,
                                      dp=dp)
    pf_specs = {name: spec[1:] for name, spec in zip(
        prefill_cache_names(cfg),
        prefill_cache_specs(cfg, pcfg, tp, s_prompt, dp=dp))}
    q8 = pcfg.kv_cache_dtype == "int8"
    stacks = dict(zip(prefill_cache_names(cfg), prefill_caches))
    local = engine is not None and engine.stack_shape == ()

    def whole(t, spec):
        """The global cache, or on local shards this process's batch rows
        of it."""
        if local:
            return gather_global(t, (None,) + tuple(spec[1:]), engine)
        return unstack(t, mesh_shape, spec)

    def place(t, spec):
        if local:
            return shard_of(t, mesh_shape, (None,) + tuple(spec[1:]),
                            engine.coords).contiguous()
        return stack_global(t, mesh_shape, spec)

    caches = []
    for layer, rows in enumerate(prefill_cache_rows(cfg)):
        entry = {name: stacks[name][row].clone() for name, row in
                 rows.items() if name in ("conv", "state", "xk", "xv")}
        for name in ("c_kv", "k_pe"):
            if name in rows:
                g = whole(stacks[name][rows[name]], pf_specs[name])
                out = g.new_zeros((g.shape[0], s_max) + tuple(g.shape[2:]))
                out[:, :s_prompt] = g
                entry[name] = place(out, decode_specs[layer][name])
        if "k" not in rows:
            caches.append(entry)
            continue
        length = layer_cache_len(cfg, layer, s_max)
        w = windows[layer]
        if w and w < s_max:
            # rolling window: position p lives at slot p % length
            take = min(length, s_prompt)
            pos = torch.arange(s_prompt - take, s_prompt)
            slots = pos % length
        else:
            pos = slots = torch.arange(s_prompt)
        for name in ("k", "v"):
            g = whole(stacks[name][rows[name]], pf_specs[name])
            src = g[:, pos.to(g.device)]                  # (B, S_p, ...)
            shape = (g.shape[0], length) + tuple(g.shape[2:])
            spec = decode_specs[layer][name]
            if q8:
                codes, scales = quantize_kv(src)
                out = torch.zeros(shape, dtype=torch.int8, device=g.device)
                sc = torch.zeros(shape[:3], dtype=torch.float32,
                                 device=g.device)
                sc[:, slots.to(g.device)] = scales
                entry[f"{name}_scale"] = place(
                    sc, decode_specs[layer][f"{name}_scale"])
                src = codes
            else:
                out = torch.zeros(shape, dtype=g.dtype, device=g.device)
            out[:, slots.to(g.device)] = src
            entry[name] = place(out, spec)
        caches.append(entry)
    return caches


@dataclasses.dataclass
class ServeSession:
    """Prefill + decode pair with automatic cache handoff, on `device`, or
    on `engine` (one engine for both steps; a `ProcessGroupEngine` serves
    this process's local shards)."""

    cfg: ArchConfig
    pcfg: ParallelConfig
    mesh_shape: dict
    tp: int
    batch: int
    s_prompt: int
    s_max: int
    device: object = "cuda"
    engine: object = None

    def __post_init__(self):
        self.mesh_shape = dict(self.mesh_shape)
        self.prefill_fn, self.prefill_ctx, _, self.bspec = \
            stages.build_prefill(self.cfg, self.pcfg, self.mesh_shape,
                                 self.batch, self.s_prompt,
                                 device=self.device, engine=self.engine)
        self.decode_fn, self.decode_ctx, _, _ = stages.build_decode_step(
            self.cfg, self.pcfg, self.mesh_shape, s_max=self.s_max,
            global_batch=self.batch, device=self.device, engine=self.engine)
        self.out_spec = (self.bspec["tokens"][0],)
        self.local = self.prefill_ctx.local

    def stack_batch(self, batch: dict) -> dict:
        """A batch of GLOBAL tensors (tokens (B, s_prompt), ...) ->
        mesh-stacked on the session's device, or this process's rows."""
        eng = self.prefill_ctx.engine
        if self.local:
            return {k: shard_of(torch.as_tensor(v), self.mesh_shape,
                                self.bspec[k], eng.coords).to(eng.device)
                    for k, v in batch.items()}
        return {k: stack_global(torch.as_tensor(v, device=eng.device),
                                self.mesh_shape, self.bspec[k])
                for k, v in batch.items()}

    def generate(self, params, tokens, n_new: int,
                 return_logits: bool = False):
        """tokens: (B, s_prompt) -> (B, n_new) greedy continuation, a CPU
        int32 tensor (on every process, one rank per process). With
        `return_logits`, also the logits each token was taken from, (B,
        n_new, V) fp32 on the CPU (the padded vocab rows cut off)."""
        batch = self.stack_batch({"tokens": tokens})
        # the step fns' plain call unless the logits are asked for
        kw = {"return_logits": True} if return_logits else {}
        out = self.prefill_fn(params, batch, **kw)
        nxt, pf_caches = out[:2]
        logits = list(out[2:])
        caches = convert_prefill_caches(
            pf_caches, self.cfg, self.pcfg, self.mesh_shape, self.tp,
            self.batch, self.s_prompt, self.s_max,
            engine=self.prefill_ctx.engine)
        del pf_caches, out
        toks = [nxt]
        for i in range(n_new - 1):
            step = self.decode_fn(params, caches, nxt[..., None],
                                  self.s_prompt + i, **kw)
            nxt, caches = step[:2]
            logits.extend(step[2:])
            toks.append(nxt)
        gen = self._whole(torch.stack(toks, dim=-1), (None,))
        if not return_logits:
            return gen
        # (*mesh, B_l, V_l) a step -> (B, n_new, V)
        lg = self._whole(torch.stack(logits, dim=-2),
                         (None, self.pcfg.tp_axis))
        return gen, lg[..., :self.cfg.vocab_size].float()

    def _whole(self, t, trailing: tuple):
        """The global (B, ...) tensor of stacked (or local) per-rank rows
        laid out by the batch's spec then `trailing` (an axis the mesh
        lacks: replicated), on the CPU."""
        spec = self.out_spec + tuple(a if a in self.mesh_shape else None
                                     for a in trailing)
        if self.local:
            return gather_global(t, spec, self.prefill_ctx.engine).cpu()
        return unstack(t, self.mesh_shape, spec).cpu()
