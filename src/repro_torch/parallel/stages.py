"""Step builders: train_step, prefill and decode_step over the mesh.

Port of `repro/parallel/stages.py`. The reference runs each step inside
ONE shard_map over the mesh and jits it; the port has no jit and no
shard_map: every rank is a row of a mesh-stacked tensor
(`parallel/ops.py`), every collective — FSDP gathers, TP reductions, EP
all-to-alls, DP gradient sync — is issued by the CollectiveEngine on the
whole stack (backend 'microcode' = the paper's CCLO; 'native' = plain
torch reductions), and the builders return plain callables over stacked
tensors. Params are drawn in the layout the step that takes them expects
(`serve=True`: the serving layout, weights replicated over 'data'; the
FSDP layout for training); the reference lets jax reshard an FSDP-laid
param tree at the call.

Gradient sync rule (tests/test_torch_grad_semantics.py): the backward
differentiates the sum of the per-rank losses through the engine's
adjoint Functions (`core/autograd.py`), so a param's gradient must be
allreduced over every mesh axis absent from its spec. Leaves are
bucketed by their missing-axis set and synced with fused engine
allreduces per bucket, optionally int8/bf16-compressed; by default the
buckets go through the engine's non-blocking request queue
(`itree_allreduce`): all groups issue before any waits, the paper's
offload-engine enqueue-then-overlap pattern
(`ParallelConfig.async_grad_sync`). The train step updates the params and
the optimizer state IN PLACE (the reference donates both; ROADMAP
Queue 3).

One rank per process (the reference's multi-host launch): every builder
takes an `engine`, and on a `core/procgroup.py::ProcessGroupEngine`
(`process_engine` builds one) the step takes and returns this process's
LOCAL shards — params, caches, batches, grads, the optimizer state —
with no mesh dims leading (`ParCtx.lead == 0`).
`init_params` / `init_cache` / `param_shapes` give them with `coords`
(the process's mesh position) and `TrainStep.put_batch` cuts a global
batch to the process's rows (`convert.shard_of`). The collectives are
the stacked engine's programs on the same operands, bitwise; the plain
products are 2-D there, batched over the ranks here, so they sum in
another order (ROADMAP Queue 3). Every family runs so: the MoE's
dispatch, the SSM mixer's carries, the hybrid's two branches, the audio
encoder and the VLM prefix take local shards as they take stacked rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.core.engine import CollectiveEngine
from repro_torch.models import lm as lm_mod
from repro_torch.models import serve as serve_mod
from repro_torch.models.common import Builder, dt
from repro_torch.optim import adamw
from repro_torch.parallel.ops import ParCtx, spec_axes
from repro_torch.tree import flatten, tree_map, unflatten


def make_ctx(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
             device="cuda", engine=None) -> ParCtx:
    """The step's parallel context on `engine` (a stacked
    `CollectiveEngine` or this process's `ProcessGroupEngine`), or on a
    new stacked engine, which raises on device='cuda' without a card."""
    if engine is None:
        engine = CollectiveEngine(dict(mesh_shape), backend=pcfg.backend,
                                  device=device)
    if dict(engine.mesh_shape) != dict(mesh_shape):
        raise ValueError(f"engine mesh {engine.mesh_shape} is not "
                         f"{dict(mesh_shape)}")
    return ParCtx(engine=engine, pcfg=pcfg)


def process_engine(mesh_shape: dict, backend: str = "microcode",
                   device="cuda"):
    """This process's `ProcessGroupEngine` over the initialized world: on
    the card it picks (`cuda:{LOCAL_RANK % count}`, raising without one)
    unless `device` is 'cpu'."""
    from repro_torch.core.procgroup import ProcessGroupEngine
    cpu = torch.device(device).type == "cpu"
    return ProcessGroupEngine(dict(mesh_shape), backend=backend,
                              device="cpu" if cpu else None)


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def _drop_data_axis(spec) -> tuple:
    return tuple(None if e == "data" else e for e in spec)


def param_specs(cfg: ArchConfig, tp: int, serve: bool = False):
    """The param tree's spec entries; serve=True: the serving layout,
    weights replicated over 'data' (pure TP) — no ZeRO-3 gathers on the
    token path."""
    b = Builder("spec", spec_map=_drop_data_axis if serve else None)
    return lm_mod.model_params(b, cfg, tp)


def init_params(cfg: ArchConfig, mesh_shape: dict, tp: int, seed: int = 0,
                device="cuda", serve: bool = False, coords=None):
    """Random params drawn on `device` from `seed` (a torch.Generator),
    mesh-stacked in the FSDP layout or, with serve=True, the serving
    layout. With `coords` (a process's mesh position) that process's
    local shards, bitwise the stacked init's rows
    (`models/common.py::Builder`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b = Builder("init", generator=gen, mesh_shape=dict(mesh_shape),
                device=device, dtype=dt(cfg.param_dtype),
                spec_map=_drop_data_axis if serve else None,
                coords=coords, seed=seed)
    return lm_mod.model_params(b, cfg, tp)


def param_shapes(cfg: ArchConfig, mesh_shape: dict, tp: int, dtype=None,
                 serve: bool = False, coords=None):
    """The param tree as storage-free 'meta' tensors of the stacked shapes
    and dtypes `init_params` draws (the reference's ShapeDtypeStructs);
    with `coords`, the local shapes."""
    b = Builder("shape", mesh_shape=dict(mesh_shape),
                dtype=dtype or dt(cfg.param_dtype),
                spec_map=_drop_data_axis if serve else None, coords=coords)
    return lm_mod.model_params(b, cfg, tp)


# --------------------------------------------------------------------------
# Gradient sync
# --------------------------------------------------------------------------

def _layered(path) -> bool:
    return path[0] in ("layers", "enc_layers")


def _mesh_major(leaf, path, D: int):
    """A leaf with its mesh dims leading: a layer-stacked (L, *mesh, ...)
    leaf moves its layer dim behind them (one rank's local array is then
    (L, ...), the reference's)."""
    return leaf.movedim(0, D).contiguous() if _layered(path) else leaf


def _rank_sum_sq(leaf, path, D: int):
    """Each rank's sum of squares (fp32) of a leaf, stacked (*mesh,)."""
    lay = int(_layered(path))
    dims = tuple(d for d in range(leaf.ndim) if not lay <= d < lay + D)
    return torch.sum(torch.square(leaf.float()), dim=dims)


def grad_sync(grads, specs, ctx: ParCtx, compression=None,
              use_queue: bool = True):
    """Bucketed, engine-routed gradient synchronization.

    With `use_queue` (`ParallelConfig.async_grad_sync`), every sync
    group's bucketed allreduces are ISSUED into the engine's request
    queue first (`itree_allreduce` — the non-blocking CCLO offload path)
    and only then waited, so small same-dtype buckets coalesce into one
    program and independent buckets drain back to back; the queue's
    coalescing eligibility rule makes this bitwise-identical to the
    blocking path (`tree_allreduce`). Axes are ordered 'data' and
    'model' first, 'pod' (the slow fabric) last.

    Returns (synced grads, each rank's sum of squares stacked (*mesh,)
    (0-d on local shards),
    corrected for replication: each leaf's contribution divided by its
    replication factor, so one allreduce over the full mesh yields the
    true norm)."""
    mesh = ctx.mesh_shape
    D = ctx.lead
    mesh_axes = [a for a in mesh if mesh[a] > 1]
    spec_of = dict(flatten(specs))
    buckets: dict = {}
    for path, leaf in flatten(grads):
        spec = spec_of[path]
        missing = tuple(a for a in mesh_axes if a not in spec_axes(spec))
        buckets.setdefault(missing, []).append((path, leaf))

    # issue phase: every sync group's bucket collectives are enqueued
    # before any is materialized
    tickets = {}
    for missing, entries in buckets.items():
        if not missing:
            continue
        leaves = [_mesh_major(l, p, D) for p, l in entries]
        order = [a for a in ("data", "model") if a in missing] + \
                [a for a in missing if a not in ("data", "model")]
        if use_queue:
            tickets[missing] = ctx.engine.itree_allreduce(
                leaves, order, compression=compression)
        else:
            tickets[missing] = ctx.engine.tree_allreduce(
                leaves, order, compression=compression)

    if use_queue and tickets:
        # the mesh-level price of the outstanding gradient exchange (the
        # trainer logs it per step, `Trainer._queue_stats`)
        from repro_torch.core.mesh_cost import MeshMakespan
        ctx.engine.metrics.set("grad_sync_makespan_s",
                               MeshMakespan.of(ctx.engine.queue).total())

    out = []
    sq = torch.zeros(ctx.engine.stack_shape, dtype=torch.float32,
                     device=ctx.engine.device)
    for missing, entries in buckets.items():
        repl = 1
        for a in missing:
            repl *= mesh[a]
        if missing:
            t = tickets[missing]
            synced = [g.movedim(D, 0) if _layered(p) else g for (p, _), g
                      in zip(entries, t.wait() if use_queue else t)]
        else:
            synced = [l for _, l in entries]
        for (path, _), g in zip(entries, synced):
            sq = sq + _rank_sum_sq(g, path, D) / repl
            out.append((path, g))
    return unflatten(out), sq


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainStep:
    fn: object            # step(params, opt_state, batch, step_idx)
    ctx: ParCtx
    specs: object         # param spec tree
    opt_specs: object
    batch_spec: object

    def put_batch(self, batch) -> dict:
        """A batch of global arrays (numpy or torch) on the step's device
        by its batch specs: stacked, or on local shards this process's
        rows (`convert.shard_of`)."""
        from repro_torch.convert import shard_of, stack_global
        eng = self.ctx.engine
        if self.ctx.local:
            return {k: shard_of(torch.as_tensor(v), self.ctx.mesh_shape,
                                self.batch_spec[k], eng.coords)
                    .to(eng.device) for k, v in batch.items()}
        return {k: stack_global(torch.as_tensor(v).to(eng.device),
                                self.ctx.mesh_shape, self.batch_spec[k])
                for k, v in batch.items()}

    def data_shard(self) -> tuple:
        """(index, count) of this process's rows of the global batch: its
        data-parallel rank and size on local shards (the rows
        `put_batch` keeps, for `data.make_loader`), else (0, 1)."""
        if not self.ctx.local:
            return 0, 1
        mesh, coords = self.ctx.mesh_shape, self.ctx.engine.coords
        idx, count = 0, 1
        for a in self.batch_spec["tokens"][0] or ():
            idx, count = idx * mesh[a] + coords[a], count * mesh[a]
        return idx, count

    def put_rows(self, batch) -> dict:
        """This process's rows of a batch, as the loader at `data_shard`
        gives them, on the step's device (stacked: `put_batch`)."""
        if not self.ctx.local:
            return self.put_batch(batch)
        dev = self.ctx.engine.device
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _microbatch(batch, k: int, j: int, D: int) -> dict:
    """Microbatch j of k: rows [j b/k, (j+1) b/k) of each rank's batch."""
    out = {}
    for name, leaf in batch.items():
        bk = leaf.shape[D] // k
        out[name] = leaf.narrow(D, j * bk, bk)
    return out


def _rank0(t):
    """The value of mesh position (0, ..., 0) (the reference's out_specs
    P() reads one device's copy)."""
    return t.reshape(-1)[0] if t.ndim else t


def build_train_step(cfg: ArchConfig, pcfg: ParallelConfig,
                     mesh_shape: dict, opt_cfg: adamw.AdamWConfig,
                     lr_schedule=None, device="cuda",
                     engine=None) -> TrainStep:
    """The train step over FSDP-layout params (`init_params`): forward and
    backward of the stacked per-rank losses (microbatched), `grad_sync`,
    the global clip through the engine's scalar allreduces, the lr
    schedule, AdamW with its own clip off, and the compute-dtype params
    from the masters. `fn(params, opt_state, batch, step_idx)` updates
    params and opt_state in place and returns (params, opt_state,
    metrics) with 0-d metrics ce_mean, aux, grad_norm and loss (rank 0's
    where they differ by rank; on local shards this process's)."""
    ctx = make_ctx(cfg, pcfg, mesh_shape, device, engine)
    specs = param_specs(cfg, ctx.tp)
    ospecs = adamw.opt_specs(specs)
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape)
    bspec = lm_mod.batch_specs(cfg, "train", dp=dp)
    D = ctx.lead
    pdtype = dt(cfg.param_dtype)
    cfg_noclip = dataclasses.replace(opt_cfg, grad_clip=1e30)

    def value_and_grad(params, mb):
        """(per-rank loss, metrics, grads) of the sum of the per-rank
        losses. A layer-stacked leaf enters as a list of its layers (the
        `layer_slice` of each is then a leaf of its own), so its gradient
        is one stack of the layers' instead of a sum of L full-size
        select-backward buffers."""
        pairs, req, tree = flatten(params), [], []
        for path, p in pairs:
            if _layered(path):
                layers = [t.detach().requires_grad_() for t in p.unbind(0)]
                req.extend(layers)
                tree.append((path, layers))
            else:
                req.append(p.detach().requires_grad_())
                tree.append((path, req[-1]))
        loss, metrics = lm_mod.loss_fn(unflatten(tree), mb, cfg, ctx)
        it = iter(torch.autograd.grad(loss.sum(), req, allow_unused=True,
                                      materialize_grads=True))
        grads = [(path, torch.stack([next(it) for _ in range(p.shape[0])])
                  if _layered(path) else next(it)) for path, p in pairs]
        return loss.detach(), metrics, unflatten(grads)

    def step(params, opt_state, batch, step_idx):
        k = pcfg.microbatches
        if k <= 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            # gradient accumulation: one backward per microbatch, fp32
            # accumulators, grads / loss / metrics averaged
            g_acc = loss = metrics = None
            for j in range(k):
                l, m, g = value_and_grad(params, _microbatch(batch, k, j, D))
                g = tree_map(lambda t: t.float(), g)
                if g_acc is None:
                    g_acc, loss, metrics = g, l, m
                else:
                    g_acc = tree_map(torch.add, g_acc, g)
                    loss = loss + l
                    metrics = {n: metrics[n] + m[n] for n in metrics}
            grads = tree_map(lambda t: t / k, g_acc)
            loss = loss / k
            metrics = {n: v / k for n, v in metrics.items()}
        grads, sq = grad_sync(grads, specs, ctx,
                              compression=pcfg.grad_compression,
                              use_queue=pcfg.async_grad_sync)
        # global clip norm: one scalar allreduce per live mesh axis
        for a in (a for a in mesh_shape if mesh_shape[a] > 1):
            sq = ctx.engine.allreduce(sq, a)
        gnorm = torch.sqrt(sq)                              # (*mesh,)
        scale = torch.clamp(opt_cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            max=1.0)

        def clip(path, g):
            lay = int(_layered(path))
            s = scale.reshape((1,) * lay + scale.shape
                              + (1,) * (g.ndim - D - lay))
            return g.float() * s
        grads = unflatten([(path, clip(path, g))
                           for path, g in flatten(grads)])
        lr_scale = lr_schedule(step_idx) if lr_schedule else 1.0
        adamw.adamw_update(cfg_noclip, grads, opt_state, lr_scale=lr_scale,
                           inplace=True)
        del grads
        adamw.apply_updates(opt_state, pdtype, params)
        out = {"ce_mean": metrics["ce_mean"], "aux": metrics["aux"],
               "grad_norm": gnorm, "loss": loss}
        return params, opt_state, {n: _rank0(v) for n, v in out.items()}

    return TrainStep(fn=step, ctx=ctx, specs=specs, opt_specs=ospecs,
                     batch_spec=bspec)


# --------------------------------------------------------------------------
# Serve steps
# --------------------------------------------------------------------------

def dp_axes(mesh_shape: dict, global_batch: int):
    """DP sharding axes for a batch dim; None (replicate) when the batch
    is smaller than the DP group (B=1 long-context decode)."""
    axes = tuple(a for a in ("pod", "data")
                 if a in mesh_shape and mesh_shape[a] > 1)
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return axes if axes and global_batch % n == 0 else None


def build_prefill(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
                  global_batch: int, seq_len: int, device="cuda",
                  engine=None):
    """(prefill fn, ctx, param specs, batch specs). The fn takes the
    serving-layout params and a stacked batch of `seq_len` tokens and
    returns (next tokens stacked (*mesh, B_local), layer-stacked caches
    laid out by `serve.prefill_cache_specs`), and with `return_logits`
    the last position's logits, each rank's vocab slice (*mesh, B_local,
    V / tp)."""
    pcfg = dataclasses.replace(pcfg, serving=True)
    ctx = make_ctx(cfg, pcfg, mesh_shape, device, engine)
    specs = param_specs(cfg, ctx.tp, serve=True)
    dp = dp_axes(mesh_shape, global_batch)
    bspec = lm_mod.batch_specs(cfg, "prefill", dp=dp)

    @torch.inference_mode()
    def pf(params, batch, return_logits: bool = False):
        s = batch["tokens"].shape[-1]
        if s != seq_len:
            raise ValueError(f"prefill built for {seq_len} tokens, got {s}")
        return serve_mod.prefill(params, batch, cfg, ctx,
                                 return_logits=return_logits)

    return pf, ctx, specs, bspec


def cache_specs(cfg: ArchConfig, pcfg: ParallelConfig, tp: int,
                s_max: int, s_enc: int = 0, dp=("pod", "data")):
    return serve_mod.make_cache(Builder("spec"), cfg, tp, 0, s_max, pcfg,
                                s_enc=s_enc, dp=dp)


def cache_shapes(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
                 tp: int, batch: int, s_max: int, s_enc: int = 0,
                 dp=("pod", "data")):
    """The decode caches as storage-free 'meta' tensors of the stacked
    shapes and dtypes `init_cache` makes (the reference's
    ShapeDtypeStructs); the dry run's decode cells take them."""
    b = Builder("shape", mesh_shape=dict(mesh_shape),
                dtype=dt(cfg.param_dtype))
    return serve_mod.make_cache(b, cfg, tp, batch, s_max, pcfg, s_enc=s_enc,
                                dp=dp)


def init_cache(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
               tp: int, batch: int, s_max: int, s_enc: int = 0,
               device="cuda", coords=None):
    """Zero decode caches, mesh-stacked on `device` (with `coords`, a
    process's local shards)."""
    b = Builder("init", mesh_shape=dict(mesh_shape), device=device,
                dtype=dt(cfg.param_dtype), coords=coords)
    return serve_mod.make_cache(b, cfg, tp, batch, s_max, pcfg, s_enc=s_enc,
                                dp=dp_axes(mesh_shape, batch))


def build_decode_step(cfg: ArchConfig, pcfg: ParallelConfig,
                      mesh_shape: dict, s_max: int, global_batch: int,
                      s_enc: int = 0, device="cuda", engine=None):
    """(decode fn, ctx, param specs, cache specs). The fn takes the
    serving-layout params, the caches, stacked tokens (*mesh, B_local,
    1) and the position `pos` (an int) and returns (next tokens stacked
    (*mesh, B_local), the caches, written in place), and with
    `return_logits` the head's logits (*mesh, B_local, V / tp)."""
    pcfg_d = dataclasses.replace(pcfg, sequence_parallel=False,
                                 serving=True)
    ctx = make_ctx(cfg, pcfg_d, mesh_shape, device, engine)
    specs = param_specs(cfg, ctx.tp, serve=True)
    cspecs = cache_specs(cfg, pcfg_d, ctx.tp, s_max, s_enc=s_enc,
                         dp=dp_axes(mesh_shape, global_batch))

    @torch.inference_mode()
    def dstep(params, caches, tokens, pos: int, return_logits: bool = False):
        return serve_mod.decode_step(params, caches, tokens, int(pos), cfg,
                                     ctx, s_max, return_logits=return_logits)

    return dstep, ctx, specs, cspecs
