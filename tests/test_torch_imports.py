"""The port stays free of jax and of the reference package.

In a fresh interpreter with `jax` and `repro` blocked in `sys.modules`
(any import of them raises), every module under `src/repro_torch/`
(found by walking the package, so new modules are covered; the
training stack's and the per-process modules must be among them) and every
module `chip_smoke.py` imports (found in its syntax tree, the imports
inside its functions included) must import, and `chip_smoke` itself —
and so must the test cases the spawned children import
(`tests/_torch_*_cases.py` that run without jax).
"""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names + {smoke!r} + ["chip_smoke"] + {cases!r}:
    importlib.import_module(name)
missing = [m for m in {training!r} if m not in names]
assert not missing, missing
leaked = [m for m, mod in sys.modules.items() if mod is not None and
          m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not leaked, leaked
print(len(names))
"""


def _chip_smoke_imports() -> list:
    """Absolute modules chip_smoke.py imports anywhere in its body."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


# the training stack's modules, each of which must be found and import
# without jax or the reference package
TRAINING = ["repro_torch.core.autograd", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.checkpoint", "repro_torch.checkpoint.store",
            "repro_torch.runtime.trainer", "repro_torch.runtime.health",
            "repro_torch.launch.train"]
# one rank per process: the per-rank data plane and its launcher; the
# native backend, the ring ops, ParCtx and the DLRM on local shards
PROCESSES = ["repro_torch.core.procgroup", "repro_torch.launch.procs",
             "repro_torch.core.engine", "repro_torch.parallel.ops",
             "repro_torch.models.common", "repro_torch.models.dlrm",
             "repro_torch.convert", "repro_torch.launch.dlrm_serve",
             "repro_torch.launch.analysis",
             # LM serving and training one rank per process
             "repro_torch.parallel.stages", "repro_torch.models.lm",
             "repro_torch.models.blocks", "repro_torch.models.serve",
             "repro_torch.models.attention",
             "repro_torch.runtime.serve_session", "repro_torch.launch.serve"]
# the cases spawned children import
CASES = ["_torch_procs_cases", "_torch_streams_cases",
         "_torch_lm_procs_cases"]


def test_port_imports_without_jax_or_reference():
    smoke = _chip_smoke_imports()
    assert "repro_torch.runtime" in smoke and "torch" in smoke
    assert "repro_torch.optim" in smoke
    assert "repro_torch.core.procgroup" in smoke     # phase 12
    code = _CHECK.format(src=str(ROOT / "src"), root=str(ROOT),
                         tests=str(ROOT / "tests"), smoke=smoke,
                         training=TRAINING + PROCESSES, cases=CASES)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    # the package's modules, the LM and training stacks' included
    assert int(r.stdout.split()[-1]) >= 60
