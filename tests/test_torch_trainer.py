"""The port's fault-tolerant trainer, data pipeline and checkpoints,
mirroring `tests/test_runtime.py` (failure recovery exactness, shrink and
continue after a dead rank, elastic reshard, the manager's atomic commit,
the straggler watchdog, loader resume, memmap), plus: the port's batches
equal the reference's bitwise, and a checkpoint written by either
package loads into the other (the reference's on-disk format).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import MemmapTokens as JaxMemmapTokens
from repro.optim import adamw as jax_adamw
from repro.parallel import stages as jax_stages
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, latest_step, \
    load_checkpoint, save_checkpoint
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.data import DataConfig, MemmapTokens, SyntheticLM, \
    make_loader
from repro_torch.optim import adamw
from _torch_train_cases import one_torch_thread  # noqa: F401
from repro_torch import tree
from repro_torch.parallel import stages
from repro_torch.runtime import FailureInjector, RankFailure, \
    StragglerWatchdog, Trainer, TrainerConfig

MESH222 = {"pod": 2, "data": 2, "model": 2}
MESH111 = {"pod": 1, "data": 1, "model": 1}


def _trainer(mesh, ckpt_dir, total=10, injector=None, seed=1):
    cfg = reduced_config(get_config("smollm-360m"))
    pcfg = ParallelConfig(backend="microcode", remat="none")
    dcfg = DataConfig(global_batch=4, seq_len=16, seed=seed)
    return Trainer(cfg, pcfg, mesh, adamw.AdamWConfig(lr=1e-3), dcfg,
                   TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                 ckpt_every=4), injector=injector,
                   device="cpu")


def test_failure_recovery_exact(tmp_path):
    """A chip failure at step 5 restarts from the step-3 checkpoint; the
    ce_mean trajectory equals an uninterrupted run's within 1e-5 (the
    reference's tolerance)."""
    log_ref = _trainer(MESH222, str(tmp_path / "a"), total=10).run()
    log_rec = _trainer(MESH222, str(tmp_path / "b"), total=10,
                       injector=FailureInjector(fail_at=(5,))).run()
    events = [r for r in log_rec if "event" in r]
    assert len(events) == 1 and events[0]["event"] == "failure"
    ref = {r["step"]: r["ce_mean"] for r in log_ref if "step" in r}
    rec = {r["step"]: r["ce_mean"] for r in log_rec if "step" in r}
    assert sorted(rec) == list(range(4, 10))
    for s in rec:
        assert abs(ref[s] - rec[s]) < 1e-5, f"divergence at step {s}"
    # the queue counters ride every row
    assert all(r["queue_issued"] >= 1 for r in log_ref if "step" in r)


def test_rank_failure_shrink_and_continue(tmp_path):
    """A dead rank during grad sync: the trainer shrinks the data axis to
    the survivors and continues from IN-MEMORY state — no checkpoint
    restore, no lost pre-failure steps."""
    t = _trainer(MESH222, str(tmp_path / "d"), total=8,
                 injector=FailureInjector(rank_fail_at=((4, 1),)))
    t.tcfg.ckpt_every = 100
    log = t.run()
    events = [r for r in log if "event" in r]
    assert len(events) == 1 and events[0]["event"] == "rank_failure"
    assert events[0]["rank"] == 1 and events[0]["axis"] == "data"
    assert [r["step"] for r in log if "step" in r] == list(range(8))
    assert t.mesh["data"] == 1
    post = [r for r in log if r.get("step", -1) >= 4]
    assert all(np.isfinite(r["ce_mean"]) for r in post)


def test_rank_failure_nonprefix_survivor_keeps_shard(tmp_path):
    """Rank 0 of the data axis dies: the survivor is global rank 1, and
    every leaf replicated along 'data' carries on from rank 1's own copy
    (the state is re-stacked, not truncated to a prefix)."""
    t = _trainer(MESH222, str(tmp_path / "m"), total=8,
                 injector=FailureInjector(rank_fail_at=((4, 0),)))
    t.tcfg.ckpt_every = 100
    seen = {}
    real = t._shrink_to_survivors

    def shrink(failure):
        params, _opt, _step = failure.state
        # make the two data ranks' copies of a replicated leaf differ
        params["final_norm"][:, 1] += 1.0
        seen["rank1"] = params["final_norm"][:, 1].clone()
        out = real(failure)
        seen["after"] = out[0]["final_norm"].clone()
        return out
    t._shrink_to_survivors = shrink
    log = t.run()
    events = [r for r in log if "event" in r]
    assert events[0]["survivors"] == [1]
    assert t._axis_comms["data"].global_ranks == (1,)
    assert torch.equal(seen["after"][:, 0], seen["rank1"])
    assert t.mesh == {"pod": 2, "data": 1, "model": 2}
    assert [r["step"] for r in log if "step" in r] == list(range(8))


def test_rank_failure_no_survivors_reraises(tmp_path):
    t = _trainer(MESH111, str(tmp_path / "e"), total=6,
                 injector=FailureInjector(rank_fail_at=((2, 0),)))
    t.tcfg.ckpt_every = 100
    with pytest.raises(RankFailure):
        t.run()


def test_elastic_reshard_resume(tmp_path):
    """A (2, 2, 2) checkpoint resumes on the (1, 1, 1) mesh."""
    d = str(tmp_path / "c")
    _trainer(MESH222, d, total=6).run()
    log2 = _trainer(MESH111, d, total=8).run()
    steps = [r["step"] for r in log2 if "step" in r]
    assert steps and steps[0] >= 4


def test_checkpoint_atomic_commit(tmp_path):
    d = str(tmp_path / "d")
    mgr = CheckpointManager(d, keep=2)
    state = {"w": np.arange(6.0).reshape(2, 3)}
    for step in (1, 2, 3):
        mgr.save(step, state, blocking=True)
    assert latest_step(d) == 3
    assert not os.path.exists(os.path.join(d, "step_000000001"))
    os.makedirs(os.path.join(d, "step_000000009"))
    assert latest_step(d) == 3


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=3.0, patience=2, warmup=3)
    for i in range(20):
        assert wd.observe(i, 0.1) is None
    flagged = [(i, z) for i in range(20, 23)
               if (z := wd.observe(i, 5.0)) is not None]
    assert flagged, "watchdog must flag a persistent straggler"


def test_data_loader_resume_determinism():
    cfg = reduced_config(get_config("smollm-360m"))
    dcfg = DataConfig(global_batch=4, seq_len=8, seed=7)
    l1 = make_loader(dcfg, cfg, start_step=0)
    batches = {}
    for _ in range(5):
        s, b = next(l1)
        batches[s] = b["tokens"].copy()
    l1.close()
    l2 = make_loader(dcfg, cfg, start_step=3)
    s, b = next(l2)
    l2.close()
    assert s == 3
    np.testing.assert_array_equal(b["tokens"], batches[3])


def test_memmap_source(tmp_path):
    cfg = reduced_config(get_config("smollm-360m"))
    toks = np.arange(4 * 9 * 10, dtype=np.int32) % cfg.vocab_size
    path = str(tmp_path / "corpus.bin")
    toks.tofile(path)
    dcfg = DataConfig(global_batch=4, seq_len=8, seed=0, source="memmap",
                      memmap_path=path)
    loader = make_loader(dcfg, cfg)
    s, b = next(loader)
    loader.close()
    assert b["tokens"].shape == (4, 8)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    jb = JaxMemmapTokens(JaxDataConfig(global_batch=4, seq_len=8,
                                       source="memmap", memmap_path=path),
                         jax_reduced_config(jax_get_config("smollm-360m"))
                         ).batch_at(3, 1, 4)
    pb = MemmapTokens(dcfg, cfg).batch_at(3, 1, 4)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])


@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-26b",
                                  "whisper-medium"])
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batches_bitwise_equal_reference(arch, step):
    """SyntheticLM's batch at (seed, step), any row range, equals the
    reference's bitwise (tokens, labels, a VLM's visual prefix, the
    audio family's frames)."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jb = JaxSyntheticLM(JaxDataConfig(global_batch=6, seq_len=12, seed=3),
                        jcfg).batch_at(step, 1, 5)
    pb = SyntheticLM(DataConfig(global_batch=6, seq_len=12, seed=3),
                     cfg).batch_at(step, 1, 5)
    assert sorted(jb) == sorted(pb)
    for k in jb:
        assert pb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(pb[k], jb[k])


# --------------------------------------------------------------------------
# Checkpoints across the packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state(mesh222):
    """The reference trainer's state tree {"params", "opt"} and its specs
    on the (2, 2, 2) mesh, after one AdamW update (so m, v, count are not
    trivial)."""
    jcfg = jax_reduced_config(jax_get_config("smollm-360m"))
    params = jax_stages.init_params(jcfg, mesh222, 2, seed=4)
    opt = jax_adamw.adamw_init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         params)
    opt, _ = jax_adamw.adamw_update(jax_adamw.AdamWConfig(), grads, opt)
    specs = jax_stages.param_specs(jcfg, 2)
    state = {"params": params, "opt": opt}
    return state, {"params": specs, "opt": jax_adamw.opt_specs(specs)}


def _port_state_specs(cfg):
    specs = stages.param_specs(cfg, 2)
    return {"params": specs, "opt": adamw.opt_specs(specs)}


def _shape_tree(cfg, mesh):
    params = stages.param_shapes(cfg, mesh, 2)
    return {"params": params, "opt": {
        "leaves": tree.tree_map(
            lambda p: {n: p.float() for n in ("master", "m", "v")}, params),
        "count": torch.empty((), dtype=torch.int32, device="meta")}}


def _assert_same_state(port_tree, jax_tree, cfg, mesh):
    np_tree = jax.tree.map(np.asarray, jax_tree)
    want_p = convert.lm_params_from_jax(np_tree["params"], cfg, mesh)
    want_o = convert.opt_state_from_jax(np_tree["opt"], cfg, mesh)
    got = tree.flatten(port_tree)
    want = tree.flatten({"params": want_p, "opt": want_o})
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("mesh", [MESH222, MESH111])
def test_fsdp_state_round_trips_through_convert(jax_state, mesh):
    """The reference's FSDP-layout params and AdamW state carried into the
    port (`lm_params_from_jax`, `opt_state_from_jax`) and back come out
    bitwise, so both packages start a step from the same state."""
    jtree, _ = jax_state
    cfg = reduced_config(get_config("smollm-360m"))
    np_tree = jax.tree.map(np.asarray, jtree)
    params = convert.lm_params_from_jax(np_tree["params"], cfg, mesh)
    state = convert.opt_state_from_jax(np_tree["opt"], cfg, mesh)
    back = {"params": convert.lm_params_to_jax(params, cfg, mesh),
            "opt": convert.opt_state_to_jax(state, cfg, mesh)}
    for (path, a), b in zip(jax.tree.flatten_with_path(np_tree)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=str(path))


@pytest.mark.parametrize("mesh", [MESH222, MESH111])
def test_reference_checkpoint_loads_into_port(tmp_path, jax_state, mesh):
    """The reference's checkpoint (its save_checkpoint of the trainer's
    state) loads into the port, re-stacked onto the target mesh, every
    leaf bitwise the reference's array."""
    jtree, specs = jax_state
    jax_save(str(tmp_path), 5, jtree, specs)
    cfg = reduced_config(get_config("smollm-360m"))
    got, manifest = load_checkpoint(str(tmp_path), 5, _shape_tree(cfg, mesh),
                                    _port_state_specs(cfg), mesh)
    assert manifest["step"] == 5
    _assert_same_state(got, jtree, cfg, mesh)


def test_port_checkpoint_loads_into_reference(tmp_path, jax_state, mesh222):
    """The port's checkpoint of the same state loads into the reference
    (its load_checkpoint onto the (2, 2, 2) mesh), every leaf bitwise,
    and the two packages' files and manifests agree."""
    jtree, specs = jax_state
    cfg = reduced_config(get_config("smollm-360m"))
    np_tree = jax.tree.map(np.asarray, jtree)
    port = {"params": convert.lm_params_from_jax(np_tree["params"], cfg,
                                                 MESH222),
            "opt": convert.opt_state_from_jax(np_tree["opt"], cfg, MESH222)}
    save_checkpoint(str(tmp_path / "p"), 2, port, _port_state_specs(cfg),
                    mesh_shape=MESH222)
    got, _ = jax_load(str(tmp_path / "p"), 2, jtree, specs, mesh222)
    for (path, a), b in zip(jax.tree.flatten_with_path(jtree)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=str(path))
    jax_save(str(tmp_path / "j"), 2, jtree, specs)
    import json
    with open(tmp_path / "p" / "step_000000002" / "manifest.json") as f:
        mp = json.load(f)
    with open(tmp_path / "j" / "step_000000002" / "manifest.json") as f:
        mj = json.load(f)
    assert mp == mj


def test_bf16_checkpoint_round_trip(tmp_path):
    """A bf16 leaf is stored as the reference's numpy writes it (2-byte
    records, dtype "bfloat16") and reads back bitwise."""
    cfg = reduced_config(get_config("smollm-360m"), param_dtype="bfloat16")
    params = stages.init_params(cfg, MESH222, 2, seed=1, device="cpu")
    specs = stages.param_specs(cfg, 2)
    save_checkpoint(str(tmp_path), 1, params, specs, mesh_shape=MESH222)
    arr = np.load(tmp_path / "step_000000001" / "embed.npy")
    assert arr.dtype == np.dtype("V2")
    got, m = load_checkpoint(str(tmp_path), 1, params, specs, MESH222)
    assert m["leaves"]["embed"]["dtype"] == "bfloat16"
    for (p, a), (_, b) in zip(tree.flatten(params), tree.flatten(got)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), p
