"""The benchmark's frame: the command line, ``BENCHMARK.json``, the files
found by name, the environment, the checks every run makes and the result
line.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell (``workloads`` entry) names a configuration
(``port_bench/configs/<config>.json``) and a traffic mix
(``port_bench/traffic/<traffic>.json``, whose ``driver`` names the loop
that drives it, ``port_bench/drivers/<driver>.py``); its limits for
``correct`` are
``port_bench/limits/<cell>.json``; each per-layer metric is read by
``port_bench/metrics/<metric>.py``.  Adding a cell, a configuration, a mix,
a driver or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "optax", "two_stage_object_detection_tpu")


class BenchError(Exception):
    """A run that cannot give a result: exit nonzero, print none."""


def process_start_time() -> float:
    """The process's start on the wall clock (from ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a cell's first run there builds.  The program's own kernels
    build into its ``_build/``; these catch what torch would put under
    ``HOME``."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, a
    JAX library's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One ``workloads`` entry and everything found by its names."""

    def __init__(self, root: str, name: str):
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise BenchError(f"no BENCHMARK.json in {root}")
        self.spec = load_json(path)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise BenchError(f"unknown workload {name!r}; the cells are "
                             f"{sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        bench = os.path.join(root, "port_bench")
        self.traffic = load_json(os.path.join(
            bench, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench, "limits", name + ".json"))
        self.bench_dir = bench

    def metrics(self, table: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` this cell
        reports: those listing it, and those without a list whose end-to-end
        metric (their own, or the one they move) it reports."""
        e2e = {m["name"] for m in self.spec["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        out = []
        for m in self.spec[table]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif (m["name"] if table == "end_to_end" else m["moves"]) in e2e:
                out.append(m)
        return out

    def driver(self):
        """The module of the traffic's driver; its ``drive(run)`` runs the
        cell (:mod:`port_bench.runner`)."""
        name = self.traffic["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers", name + ".py"),
                           "port_bench_driver_" + name)

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py"),
                           "port_bench_metric_" + metric.replace(".", "_"))


def parse(argv):
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _number(v):
    """A metric's value as JSON takes it (an infinite latency, a request
    that never came, is reported as the largest float)."""
    return v if math.isfinite(v) else sys.float_info.max


def result_line(result: dict, cell: Cell, trace: int) -> dict:
    """The last line of standard output, ``checks`` last."""
    table = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(table):
        v = result["metrics"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": _number(float(v)),
                                  "unit": m["unit"]}
    line = {"correct": bool(result["correct"]),
            "attempted": int(result["attempted"]),
            "failed": int(result["failed"]),
            "metrics": metrics, "device": result["device"]}
    if trace and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = os.path.dirname(HERE)
    try:
        cell = Cell(root, args.workload)
    except (BenchError, OSError, KeyError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("two_stage_object_detection_tpu_torch") is None:
        print("port_bench: the program (two_stage_object_detection_tpu_torch)"
              f" is not in {root}", file=sys.stderr)
        return 2
    cache_environment(root)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell.entry["chips"])):
        print(f"port_bench: the cell needs {cell.entry['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from port_bench.runner import Run
    run = Run(root, cell, args.seed, args.seconds, args.trace, t_start,
              device=torch.device("cuda", 0))
    try:
        result = cell.driver().drive(run)
    except BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    found = banned_modules()
    if found:
        print("port_bench: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    line = result_line(result, cell, args.trace)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
