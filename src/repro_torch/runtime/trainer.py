"""Fault-tolerant training loop.

Port of `repro/runtime/trainer.py`: the loop a production job runs —
deterministic data, async checkpoints, preemption-safe shutdown,
straggler monitoring, failure recovery (checkpoint-restart on a
simulated chip loss; shrink-and-continue on a dead rank) and elastic
restart onto a different mesh (checkpoint resharding).

The mesh is a `{axis: size}` dict and every rank a row of the stacked
state on one device (`parallel/stages.py`) or, with `engine` this
process's `ProcessGroupEngine` (`stages.process_engine`; the reference's
multi-host launch), one rank per process: the step runs on local shards
(several trainers may share the engine); the params are drawn as
the stacked init's rows (`stages.init_params(coords=...)`), the loader
reads only this process's data-parallel rows (`make_loader` at
`TrainStep.data_shard()`), checkpoints are gathered to rank 0 and
written there (`checkpoint/store.py`), and the watchdog and queue stats
are the process's own. A shrink one rank per process hands the shards
along the failed axis over before the dead position's processes leave
(`_shrink_to_survivors`); the survivors carry on over an engine of
their own, and the processes that left join the creation of every later
shrink's groups until the survivors end. The trainer runs on the card
unless `device="cpu"` is given. The step updates params and optimizer
state in place, so a checkpoint snapshots them to host before the next
step. run() returns a log of per-step metrics; recover-and-continue is
exercised by tests/test_torch_trainer.py (inject a failure at step k,
restart, and the loss trajectory matches an uninterrupted run — data
and init are deterministic functions of (seed, step)). The queue
counters in each row are cumulative: the port issues its gradient
buckets into the queue on every step, where the reference's issue at
trace time only.
"""
from __future__ import annotations

import dataclasses
import itertools
import signal
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.convert import gather_global, shard_of, stack_global, \
    unstack
from repro_torch.core import telemetry
from repro_torch.data import DataConfig, make_loader
from repro_torch.optim import adamw
from repro_torch.parallel import stages
from repro_torch.core.topology import Communicator
from repro_torch.parallel.ops import spec_axes
from repro_torch.runtime.health import (
    FailureInjector, Heartbeat, RankFailure, SimulatedDeviceFailure,
    StragglerWatchdog,
)
from repro_torch.tree import flatten, tree_map, unflatten


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = "repro_ckpt"
    ckpt_every: int = 20
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    max_restarts: int = 3


def _restack(leaf, spec, path, old: dict, new: dict, axis: str, pos: int):
    """One stacked leaf moved from mesh `old` onto `new` (axis `axis` one
    shorter, position `pos` gone): a leaf sharded along the axis is
    re-cut from its global array; a leaf replicated along it keeps each
    survivor's own copy."""
    if leaf.ndim == 0:
        return leaf
    D = len(old)
    layered = any(k in ("layers", "enc_layers") for k in path)
    t = leaf.movedim(0, D) if layered else leaf
    if axis in spec_axes(spec):
        t = stack_global(unstack(t, old, spec), new, spec)
    else:
        dim = list(old).index(axis)
        keep = [i for i in range(old[axis]) if i != pos]
        t = t.index_select(dim, torch.as_tensor(keep, device=t.device))
    return (t.movedim(D, 0) if layered else t).contiguous()


def _reshard_local(leaf, spec, old_engine, new_mesh: dict, new_coords,
                   axis: str):
    """`_restack` one rank per process: this process's shard of a leaf on
    the mesh `new_mesh` (axis `axis` one shorter). A dim sharded over
    `axis` (with any other axes of its spec entry) is gathered whole
    through `old_engine` (every process of the old mesh joins) and cut to
    `new_coords`' shard (None on a process that leaves); a leaf
    replicated along the axis keeps this process's own copy."""
    if leaf.ndim == 0 or axis not in spec_axes(spec):
        return leaf
    spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
    along = tuple(e if axis in spec_axes((e,)) else None for e in spec)
    g = gather_global(leaf, along, old_engine)
    if new_coords is None:
        return None
    return shard_of(g, new_mesh, along, new_coords).contiguous()


class Trainer:
    def __init__(self, arch: ArchConfig, pcfg: ParallelConfig,
                 mesh_shape: dict, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 injector: Optional[FailureInjector] = None,
                 lr_schedule=None, device="cuda", engine=None):
        self.arch, self.pcfg, self.mesh = arch, pcfg, dict(mesh_shape)
        self.opt_cfg, self.data_cfg, self.tcfg = opt_cfg, data_cfg, tcfg
        self.injector = injector
        self.lr_schedule = lr_schedule
        per_process = engine is not None and engine.stack_shape == ()
        self.coords = engine.coords if per_process else None
        self.device = torch.device(engine.device if per_process else device)
        self.ckpt = CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep, per_process=per_process,
            engine=engine if per_process else None)
        self.watchdog = StragglerWatchdog()
        self.heartbeat = Heartbeat()
        self._preempted = False
        # axis -> rank-id-aware degraded Communicator (built up by
        # _shrink_to_survivors as failures accumulate; absent = intact)
        self._axis_comms: dict = {}
        # one rank per process, after a shrink: the global rank that
        # announces the next mesh's groups (`procgroup.announce_mesh`),
        # and whether this process has left the mesh
        self._announcer: Optional[int] = None
        self._left = False
        # per-step structured metrics (one `record()` per training step)
        self.metrics = telemetry.MetricsRegistry()
        self.ts = stages.build_train_step(arch, pcfg, self.mesh, opt_cfg,
                                          lr_schedule, device=self.device,
                                          engine=engine)

    @property
    def root(self) -> bool:
        """Whether this process prints the log (the mesh's rank 0, or
        stacked)."""
        return self.coords is None or self.ts.ctx.engine.mesh_rank == 0

    # -- state ---------------------------------------------------------------
    def _fresh_state(self):
        params = stages.init_params(self.arch, self.mesh, self.ts.ctx.tp,
                                    seed=self.tcfg.seed, device=self.device,
                                    coords=self.coords)
        return params, adamw.adamw_init(params), 0

    def _state_tree(self, params, opt):
        return {"params": params, "opt": opt}

    def _state_specs(self):
        return {"params": self.ts.specs, "opt": self.ts.opt_specs}

    def _shape_tree(self):
        params = stages.param_shapes(self.arch, self.mesh, self.ts.ctx.tp,
                                     coords=self.coords)
        opt = {"leaves": tree_map(
                   lambda p: {n: p.float() for n in ("master", "m", "v")},
                   params),
               "count": torch.empty((), dtype=torch.int32, device="meta")}
        return {"params": params, "opt": opt}

    def restore_or_init(self):
        got = self.ckpt.restore_latest(self._shape_tree(),
                                       self._state_specs(), self.mesh,
                                       self.device, self.coords)
        if got is None:
            return self._fresh_state()
        step, tree, _ = got
        return tree["params"], tree["opt"], step + 1

    # -- loop ----------------------------------------------------------------
    def _install_signals(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def run(self):
        self._install_signals()
        try:
            return self._run()
        finally:
            if self._announcer is not None and not self._left:
                # the survivors' last mesh: the processes that left return
                from repro_torch.core.procgroup import announce_mesh
                announce_mesh(self._announcer)

    def _run(self):
        restarts = 0
        log = []
        state = None
        while True:
            try:
                log.extend(self._run_once(state))
                return log
            except SimulatedDeviceFailure as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                log.append({"event": "failure", "error": str(e),
                            "restart": restarts})
                # checkpoint-restart: resume from the latest checkpoint
                state = None
                continue
            except RankFailure as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
                # shrink-and-continue: no checkpoint restore — the mesh
                # loses the dead rank, the step is rebuilt on the
                # degraded mesh, and the IN-MEMORY state carries on
                log.extend(getattr(e, "partial_log", None) or [])
                state = self._shrink_to_survivors(e)
                comm = self._axis_comms.get(e.axis)
                log.append({"event": "rank_failure", "error": str(e),
                            "rank": e.rank, "axis": e.axis,
                            "survivors": list(comm.global_ranks)
                            if comm is not None else [],
                            "mesh_shape": dict(self.mesh),
                            "restart": restarts})
                if state is None:
                    # one rank per process, at the dead position: the
                    # state is handed over and the survivors' groups made;
                    # this process joins their later meshes' groups
                    from repro_torch.core.procgroup import follow_meshes
                    log.append({"event": "left", "step": e.state[2],
                                "global_rank":
                                    self.ts.ctx.engine.global_rank})
                    follow_meshes(self._announcer)
                    return log
                continue

    def _shrink_to_survivors(self, failure: RankFailure):
        """Checkpoint-restart-free recovery from a dead rank.

        The mesh loses the dead rank's POSITION along the failed axis —
        not a prefix — and the surviving original rank ids are tracked in
        a rank-id-aware degraded `Communicator` (`without_ranks`, chained
        across repeated failures); the train step is rebuilt on the
        shrunk mesh (its engine replans every collective) and the
        in-memory params and optimizer state are re-stacked onto it
        (`_restack`): leaves replicated along the axis keep each
        survivor's own copy, leaves sharded along it are re-cut from
        their global arrays. Returns the (params, opt, step) state the
        next `_run_once` continues from.

        One rank per process every process sees the same failure (the
        injector is a function of the step) and joins the handoff on the
        old engine (`_reshard_local`). Then the mesh's first member
        announces the survivors' mesh to the whole world
        (`procgroup.announce_mesh`), and every process of the world
        takes part in creating its groups: the survivors by building
        their `ProcessGroupEngine` over it (`members`: their global
        ranks), the processes at the dead position through
        `procgroup.mesh_groups`, and those that left at an earlier shrink
        in `procgroup.follow_meshes`. The processes at the dead position
        get None: `run()` then follows the later meshes and ends for
        them when the survivors end theirs."""
        if failure.state is None:
            raise failure  # failed outside the step loop: nothing to save
        axis = failure.axis
        if self.mesh[axis] <= 1:
            raise failure  # no survivors to shrink onto
        params, opt, step = failure.state
        old = dict(self.mesh)
        pos = failure.rank % old[axis]
        comm = self._axis_comms.get(axis)
        if comm is None:
            comm = Communicator(axis=axis, size=old[axis])
        self._axis_comms[axis] = comm.without_ranks([pos])
        self.mesh = {**old, axis: old[axis] - 1}
        specs, ospecs = self.ts.specs, self.ts.opt_specs
        if self.coords is not None:
            return self._shrink_local(params, opt, step, old, axis, pos,
                                      specs, ospecs)
        self.ts = stages.build_train_step(self.arch, self.pcfg, self.mesh,
                                          self.opt_cfg, self.lr_schedule,
                                          device=self.device)

        def move(tree, spec_tree):
            return unflatten([
                (path, _restack(leaf, spec, path, old, self.mesh, axis, pos))
                for (path, leaf), (_p, spec) in zip(flatten(tree),
                                                    flatten(spec_tree))])
        return move(params, specs), move(opt, ospecs), step

    def _shrink_local(self, params, opt, step, old: dict, axis: str,
                      pos: int, specs, ospecs):
        """`_shrink_to_survivors` one rank per process (see there)."""
        import torch.distributed as dist
        from repro_torch.core.procgroup import ProcessGroupEngine, \
            announce_mesh, mesh_groups
        eng = self.ts.ctx.engine
        if self._announcer is None and \
                len(eng.members) != dist.get_world_size():
            raise ValueError(
                "a shrink one rank per process needs the Trainer's engine "
                "over the whole world: every process creates the survivors' "
                "groups")
        names = list(old)
        # the survivors' global ranks in row-major order of the new mesh
        members = [eng._global(dict(zip(names, (
            c + (1 if a == axis and c >= pos else 0)
            for a, c in zip(names, idx)))))
            for idx in itertools.product(*(range(self.mesh[a])
                                           for a in names))]
        leaving = eng.coords[axis] == pos
        new_coords = None if leaving else {
            **eng.coords, axis: eng.coords[axis] - (eng.coords[axis] > pos)}

        def move(tree, spec_tree):
            return unflatten([
                (path, _reshard_local(leaf, spec, eng, self.mesh,
                                      new_coords, axis))
                for (path, leaf), (_p, spec) in zip(flatten(tree),
                                                    flatten(spec_tree))])
        params, opt = move(params, specs), move(opt, ospecs)
        announce_mesh(eng.members[0], self.mesh, members)
        self._announcer = members[0]
        if leaving:
            mesh_groups(self.mesh, members)
            self._left = True
            return None
        new = ProcessGroupEngine(self.mesh, backend=eng.backend,
                                 device=eng.device, members=members)
        self.coords = new.coords
        self.ckpt.engine = new
        self.ts = stages.build_train_step(self.arch, self.pcfg, self.mesh,
                                          self.opt_cfg, self.lr_schedule,
                                          device=self.device, engine=new)
        return params, opt, step

    def _queue_stats(self):
        """Offload-queue telemetry from the step's CollectiveEngine: how
        many collectives rode the queue and how many coalesced into
        bucketed programs, and the mesh-level price of the gradient
        exchange (recorded by `stages.grad_sync`). With no queue (grad
        sync ran blocking, or nothing to sync) the keys are present with
        explicit None values."""
        q = self.ts.ctx.engine._queue
        if q is None:
            return {"queue_issued": None, "queue_coalesced": None,
                    "grad_sync_makespan_s": None}
        out = {"queue_issued": q.stats["issued"],
               "queue_coalesced": q.stats["coalesced_requests"]}
        ms = self.ts.ctx.engine.stats.get("grad_sync_makespan_s")
        if ms is not None:
            out["grad_sync_makespan_s"] = ms
        return out

    def _save(self, step, params, opt, blocking=False):
        self.ckpt.save(step, self._state_tree(params, opt),
                       self._state_specs(), blocking=blocking,
                       mesh_shape=self.mesh)

    def _run_once(self, state=None):
        if state is not None:
            params, opt, start = state  # shrink-and-continue resume
        else:
            params, opt, start = self.restore_or_init()
        index, count = self.ts.data_shard()
        loader = make_loader(self.data_cfg, self.arch, start_step=start,
                             process_index=index, process_count=count)
        log = []
        try:
            for step, batch in loader:
                if step >= self.tcfg.total_steps or self._preempted:
                    break
                if self.injector:
                    try:
                        self.injector.check(step)
                    except RankFailure as e:
                        # attach the live state (and the metrics logged
                        # so far) so recovery needs no checkpoint restore
                        e.state = (params, opt, step)
                        e.partial_log = log
                        raise
                t0 = time.perf_counter()
                params, opt, metrics = self.ts.fn(
                    params, opt, self.ts.put_rows(batch), step)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.heartbeat.beat()
                z = self.watchdog.observe(step, dt)
                rec = {"step": step, "dt": dt, **metrics,
                       **self._queue_stats()}
                if z is not None:
                    rec["straggler_z"] = z
                self.metrics.record(**rec)
                log.append(rec)
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save(step, params, opt)
            # final blocking checkpoint (preemption-safe shutdown)
            if log:
                self._save(log[-1]["step"], params, opt, blocking=True)
        finally:
            loader.close()
            self.ckpt.wait()
        return log
