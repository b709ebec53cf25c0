"""One run of one benchmark cell of the PyTorch and CUDA port (`repro_torch`).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It makes `src` importable itself, keeps
every build and kernel cache inside the checkout (`build/`), and prints
as its last line one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device` and, last, `checks` (each number compared
with the plain reference, beside its limit). It exits non-zero, and
prints no result, without as many CUDA devices as the cell asks for, or
if the process holds `jax`, `jaxlib`, `flax` or `repro` once the window
has closed. See `PERF.md` for the cells and metrics.
"""
import time

T0 = time.time()     # process start, as near as the script sees it: setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import bench_harness
    return bench_harness.main(args, T0)


if __name__ == "__main__":
    raise SystemExit(main())
