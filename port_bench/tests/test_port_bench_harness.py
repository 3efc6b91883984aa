"""The harness finds what it runs by name, and keeps JAX out."""

import json
import os
import shutil
import subprocess
import sys
import types

from bench_tiny import ROOT
from port_bench import harness


def _copy_bench(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_new_config_traffic_driver_metric_found_from_files_and_entries(
        tmp_path):
    root = _copy_bench(tmp_path)
    bench = root / "port_bench"
    (bench / "configs" / "tiny_x.json").write_text(json.dumps(
        {"config": {"backbone": "resnet10", "fpn": True}}))
    (bench / "traffic" / "burst_x.json").write_text(json.dumps(
        {"driver": "probe_x", "rate_per_s": 3.0}))
    (bench / "drivers" / "probe_x.py").write_text(
        "def drive(run):\n    return {'rate': run.traffic['rate_per_s']}\n")
    (bench / "limits" / "tiny_x.serve.burst_x.json").write_text(
        json.dumps({"det_mismatch": 0.5}))
    (bench / "metrics" / "probe_ms.tail.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_x", "source": "https://example.org",
                            "file": "port_bench/configs/tiny_x.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_x.serve.burst_x",
                              "config": "tiny_x", "traffic": "burst_x",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].insert(0, {"name": "serve_p95_ms", "unit": "ms",
                                  "better": "lower", "bound": 0.25,
                                  "source": "host_clock",
                                  "workloads": ["tiny_x.serve.burst_x"]})
    spec["per_layer"].append({"name": "probe_ms.tail", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "serving", "moves": "serve_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.Cell(str(root), "tiny_x.serve.burst_x")
    assert cell.config["config"]["backbone"] == "resnet10"
    assert cell.traffic == {"driver": "probe_x", "rate_per_s": 3.0}
    assert cell.driver().drive(cell) == {"rate": 3.0}
    assert cell.limits == {"det_mismatch": 0.5}
    e2e = [m["name"] for m in cell.metrics("end_to_end")]
    assert e2e == ["serve_p95_ms", "setup_s"]
    layer = [m["name"] for m in cell.metrics("per_layer")]
    assert layer == ["probe_ms.tail"]        # no workloads key: moves
    assert cell.reader("probe_ms.tail").read(None) == 42.0
    # the cells already there keep their metrics
    old = harness.Cell(str(root), "hardnet39.serve.u8_bulk64")
    assert "probe_ms.tail" not in [m["name"] for m in old.metrics("per_layer")]
    assert "mfu.rate" in [m["name"] for m in old.metrics("per_layer")]


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert callable(cell.driver().drive)
        assert [m["name"] for m in cell.metrics("end_to_end")][-1] == "setup_s"
        assert len(cell.metrics("end_to_end")) >= 2
        assert cell.metrics("per_layer")
        for m in cell.metrics("per_layer"):
            assert callable(cell.reader(m["name"]).read)


def test_result_line_puts_checks_last_and_reports_only_the_tables_metrics():
    cell = harness.Cell(ROOT, "hardnet39.serve.u8_bulk64")
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"serve_img_per_s": 250.0, "setup_s": 30.0,
                          "other": 1.0},
              "device": {"platform": "gpu"},
              "checks": {"det_mismatch": {"value": 0.01, "limit": 0.1}}}
    line = harness.result_line(result, cell, 0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"serve_img_per_s", "setup_s"}
    assert line["metrics"]["serve_img_per_s"] == {"value": 250.0,
                                                  "unit": "img/s"}


def test_isolation_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "two_stage_object_detection_tpu_torch",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert not [m for m in harness.banned_modules()
                if m.startswith("two_stage_object_detection_tpu_torch")
                or m == "jaxtyping"]
    for name in ("jax.numpy", "flax", "optax", "jaxlib",
                 "two_stage_object_detection_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType("x"))
        assert name in harness.banned_modules()


def test_benchmark_code_imports_no_jax_and_refuses_without_a_card(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench import control, counts, harness, runner, served\n"
            "import port_bench.reference.detector\n"
            "print(harness.banned_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "hardnet39.serve.u8_bulk64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    root = _copy_bench(tmp_path)
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "hardnet39.serve.u8_bulk64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""
