"""The readings a cell's limits for ``correct`` are set from: the control
(the precision one step below the configuration's bfloat16), planted
faults and sound runs, each held against the float32 reference.

    python3 port_bench/control.py --workload CELL --seeds 1,2,3 \
        [--kinds fp8,half,sound] [--seconds 10]

``fp8`` puts the reference in the program's place, its products on
float8 operands (e4m3 forward, e5m2 gradients): for a serving cell its
detections on the sampled images of a run of ``--seconds``, for a
training cell the compared cycles (no window).  ``half`` (training)
plants a fault instead: the reference in the program's place trains each
micro-step on the first half of its batch alone.  ``sound`` (training)
reads the program's own set-up cycles, which the benchmark's runs
compare, without the window.  The kinds of one seed share one float32
reference.  One process for every seed; each reading goes to standard
error and, last, one JSON line of them all.  The limits in
``port_bench/limits/`` sit between the largest reading of sound runs and
the smallest of the control and the faults (``PERF.md``).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_control(root: str, name: str, seeds, seconds: float, device,
                overrides=None, traffic=None, kinds=("fp8",)) -> dict:
    """``{seed: {kind: readings}}`` of cell ``name``."""
    from port_bench import harness
    from port_bench.runner import Run
    cell = harness.Cell(root, name)
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    driver = cell.driver()
    out = {}
    for seed in seeds:
        memo, out[seed] = {}, {}
        for kind in kinds:
            run = Run(root, cell, seed, seconds, 0, time.time(), device,
                      overrides=overrides, memo=memo)
            run.control = kind
            res = driver.drive(run)
            out[seed][kind] = ({k: c["value"] for k, c in res["checks"].items()}
                               if "checks" in res else res)
            print(f"control {name} seed {seed} {kind}: {out[seed][kind]}",
                  file=sys.stderr, flush=True)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="fp8")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from port_bench import harness
    harness.cache_environment(root)
    import torch
    if not torch.cuda.is_available():
        print("port_bench/control.py needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = tuple(args.kinds.split(","))
    out = run_control(root, args.workload, seeds, args.seconds,
                      torch.device("cuda", 0), kinds=kinds)
    print(json.dumps({"workload": args.workload,
                      "readings": {str(k): v for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
