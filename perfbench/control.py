"""The readings a cell's limits are set from, at the cell's own size, on
the card: the program's number on every seed of `--seeds` (the lower
reading is their largest) and the control's on every seed of
`--control-seeds` (the upper reading is their smallest). The control is
the plain reference computed in bfloat16, the precision below the
float32 the configurations state, put in the program's place
(`fault_cases.py`). Every seed runs in this one process, each with a
short window (`--seconds`), as a run of the cell would; the benchmark's
own runs never run this.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

It prints one JSON line a reading and, last, a summary line. Each driver
names its control: `control(cell) -> (cell, program)`, where the cell
may be run through another driver (one rank per process: on one card,
as the control computes no collective).
"""
import argparse
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import bench_harness as H
    cell = H.load_cell(args.workload)
    driver = H.load_module(f"drivers/{cell.workload['driver']}.py")
    readings = {"program": [], "control": []}
    runs = [("program", s, cell, None) for s in _seeds(args.seeds)] + \
        [("control", s) + driver.control(cell)
         for s in _seeds(args.control_seeds)]
    for side, seed, c, program in runs:
        t0 = time.time()
        run = H.run_cell(c, seed, args.seconds, False, "cuda", t0, program)
        for name, (value, limit) in run.checks.items():
            readings[side].append(value)
            print(json.dumps({"side": side, "seed": seed, "check": name,
                              "value": value, "limit": limit,
                              "calls": len(run.done),
                              "seconds": time.time() - t0}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "lower": max(readings["program"], default=None),
                      "upper": min(readings["control"], default=None),
                      "program": readings["program"],
                      "control": readings["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
