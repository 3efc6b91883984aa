"""PyTorch port, the program's own spans (``utils/profiling.annotate``) and
the benchmark's readers of them (``port_bench/spans.py``), on the CPU.

* every ``tsod.*`` span of a ``Predictor`` request of two buckets and of a
  resident accumulation cycle of two micro-steps, under ``profiling.trace``,
  with its parent span;
* with no profiler recording, ``annotate`` builds no ``record_function``,
  and predict and train outputs are bitwise those of a run under a
  profiler; ``export_program`` exports a graph with no profiler op;
* each span reader on a hand-written Chrome trace, and every reader the
  benchmark had before on a trace that also holds ``tsod.*`` ranges.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_macro_step_resident)
from two_stage_object_detection_tpu_torch.serving import (
    FIELDS, Predictor, export_program)
from two_stage_object_detection_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from port_bench import readers, spans  # noqa: E402
from port_bench.trace import Timeline  # noqa: E402

# the single-scale detector at 64x64: a 4x4 map, 144 anchors
TINY = dict(input_size=(64, 64), num_classes=3, batch_size=2,
            max_gt_boxes=4, n_train_pre_nms=128, n_train_post_nms=32,
            n_test_pre_nms=64, n_test_post_nms=16, roi_n_sample=8,
            rpn_n_sample=32, max_detections=8, grad_accum_steps=2,
            compute_dtype="float32", device="cpu")
# span -> the spans it may sit in (None: outermost)
PARENTS = {
    "tsod.request": {None}, "tsod.wire": {"tsod.request"},
    "tsod.enqueue": {"tsod.request"}, "tsod.fetch": {"tsod.request"},
    "tsod.features": {"tsod.enqueue", "tsod.train_forward"},
    "tsod.detect": {"tsod.enqueue"},
    "tsod.rpn_head": {"tsod.detect", "tsod.train_forward"},
    "tsod.proposals": {"tsod.detect", "tsod.train_forward"},
    "tsod.roi_head": {"tsod.detect", "tsod.train_forward"},
    "tsod.post_process": {"tsod.detect"},
    "tsod.anchor_target": {"tsod.train_forward"},
    "tsod.proposal_target": {"tsod.train_forward"},
    "tsod.train_forward": {"tsod.micro_step"},
    "tsod.micro_step": {None}, "tsod.augment": {"tsod.micro_step"},
    "tsod.backward": {"tsod.micro_step"}, "tsod.update": {"tsod.micro_step"},
    "tsod.gather": {None},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resident(rng, n=4):
    """A device-resident set of ``n`` u8 images with 1..3 boxes each."""
    side = rng.uniform(12.0, 40.0, size=(n, 4, 2))
    xy = rng.rand(n, 4, 2) * (64 - side)
    boxes = np.concatenate([xy, xy + side], -1).astype(np.float32)
    valid = np.arange(4)[None] < rng.randint(1, 4, size=(n, 1))
    boxes[~valid] = 0.0
    return {"image": torch.from_numpy(
                rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)),
            "boxes": torch.from_numpy(boxes),
            "labels": torch.from_numpy(
                rng.randint(0, 3, (n, 4)).astype(np.int32)),
            "valid": torch.from_numpy(valid)}


def _serve_and_train(seed=0):
    """One 3-image u8 request through buckets (1, 2) (two buckets) and one
    resident cycle of 2 micro-steps with ``device_augment``: ``(answer,
    losses, parameters, state)``."""
    rng = np.random.RandomState(seed)
    cfg = Config(**TINY)
    _, state = create_train_state(cfg, seed=seed)
    pred = Predictor(cfg, state.model, batch_sizes=(1, 2), wire="u8")
    answer = pred(rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8))
    gens = [torch.Generator().manual_seed(seed + k) for k in range(2)]
    state, totals = train_macro_step_resident(
        state, _resident(rng), np.array([[0, 1], [2, 3]]), gens,
        device_augment=True)
    params = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    return answer, totals, params, state


def _recorded_spans(path):
    """``[(start, end, name, tid)]`` of the ``tsod.*`` ranges of a Chrome
    trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"], e.get("tid"))
                  for e in events if e.get("ph") == "X"
                  and e.get("name", "").startswith("tsod."))


def _parent(span, all_spans):
    holding = [r for r in all_spans if r is not span and r[3] == span[3]
               and r[0] <= span[0] and span[1] <= r[1]]
    return max(holding, key=lambda r: (r[0], -r[1]))[2] if holding else None


def test_spans_of_a_request_and_a_cycle_with_their_parents(tmp_path):
    """A request of two buckets gives 2 + 8 a bucket spans, a cycle of two
    micro-steps one gather and 10 spans a micro-step plus one update, on
    the second; each span sits in the one the table names."""
    with profiling.trace(str(tmp_path)):
        _, _, _, state = _serve_and_train()
    got = _recorded_spans(os.path.join(tmp_path, "trace.json"))
    names = [r[2] for r in got]
    assert set(names) == set(PARENTS)
    for r in got:
        assert _parent(r, got) in PARENTS[r[2]], (r[2], _parent(r, got))
    count = {n: names.count(n) for n in PARENTS}
    assert count["tsod.request"] == count["tsod.wire"] == 1
    for n in ("tsod.enqueue", "tsod.fetch", "tsod.detect",
              "tsod.post_process"):
        assert count[n] == 2, n
    for n in ("tsod.micro_step", "tsod.augment", "tsod.train_forward",
              "tsod.backward", "tsod.anchor_target", "tsod.proposal_target"):
        assert count[n] == 2, n
    # features, rpn head, proposals and roi head: two buckets, two steps
    for n in ("tsod.features", "tsod.rpn_head", "tsod.proposals",
              "tsod.roi_head"):
        assert count[n] == 4, n
    assert count["tsod.gather"] == 1 and count["tsod.update"] == 1
    steps = [r for r in got if r[2] == "tsod.micro_step"]
    (update,) = [r for r in got if r[2] == "tsod.update"]
    assert steps[1][0] <= update[0] and update[1] <= steps[1][1]
    assert state.updates == 1
    assert not torch._C._autograd._profiler_enabled()


def test_no_record_function_without_a_profiler_and_same_bits(monkeypatch):
    """While nothing records, ``annotate`` returns one shared no-op context
    and builds no ``record_function``; predict and train outputs are bitwise
    those of the same run under a profiler."""
    built = []
    real = torch.profiler.record_function

    def counted(*a, **k):
        built.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert profiling.annotate("tsod.x") is profiling.annotate("tsod.y")
    plain = _serve_and_train()
    assert built == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _serve_and_train()
    assert len(built) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(plain[0][f], traced[0][f])
    assert torch.equal(plain[1], traced[1])
    for n, p in plain[2].items():
        assert torch.equal(p, traced[2][n]), n


def test_export_holds_no_profiler_op(tmp_path):
    """``export_program`` traces with no profiler on, so the spans leave no
    op in the graph; the artifact loads and answers as the model does."""
    cfg = Config(**TINY)
    _, state = create_train_state(cfg, seed=3)
    path = str(tmp_path / "p.pt2")
    assert export_program(cfg, state.model, path, batch_size=2) > 0
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t
                            or "record_function" in t]
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    want = state.model.predict(x)
    got = program.module()(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the readers
def _trace(tmp_path, events, name="t.json"):
    """A Chrome trace of ``events``: ``(cat, name, ts, dur, corr)``."""
    out = [{"ph": "X", "cat": cat, "name": n, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}
           for cat, n, ts, dur, corr in events]
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": out}))
    return str(path)


# one served bucket: enqueue [0, 100] holding detect [20, 90] and its
# post-process [40, 90], with 3 syncs in the post-process and 1 outside;
# fetch [100, 130]; kernels launched at 5, 10, 35 and 60, run on the device
# at 10-30, 30-40, 50-55 and 80-100, a memcpy at 100-110; a slice [0, 200]
BUCKET = [
    ("user_annotation", "tsod.request", 0, 140, None),
    ("user_annotation", "tsod.enqueue", 0, 100, None),
    ("user_annotation", "tsod.features", 0, 20, None),
    ("user_annotation", "tsod.detect", 20, 70, None),
    ("user_annotation", "tsod.roi_head", 30, 10, None),
    ("user_annotation", "tsod.post_process", 40, 50, None),
    ("user_annotation", "tsod.fetch", 100, 30, None),
    ("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
    ("cuda_runtime", "cudaLaunchKernel", 10, 1, 2),
    ("cuda_runtime", "cudaLaunchKernel", 35, 1, 3),
    ("cuda_runtime", "cudaLaunchKernel", 60, 1, 4),
    ("cuda_runtime", "cudaStreamSynchronize", 45, 4, 6),
    ("cuda_runtime", "cudaMemcpyAsync", 50, 1, 7),
    ("cuda_runtime", "cudaMemcpy", 65, 2, 8),
    ("cuda_runtime", "cudaEventSynchronize", 70, 9, 9),
    ("cuda_runtime", "cudaEventSynchronize", 110, 9, 10),
    ("kernel", "conv_a", 10, 20, 1),
    ("kernel", "conv_b", 30, 10, 2),
    ("kernel", "roi_pool", 50, 5, 3),
    ("kernel", "nms_step", 80, 20, 4),
    ("gpu_memcpy", "Memcpy DtoH", 100, 10, 5),
    ("cpu_op", "aten::empty", 0, 200, None),
]
# one micro-step [0, 100]: train_forward [0, 50], backward [50, 80],
# update [80, 100]; kernels at 5-25 (launched 5), 30-40 (launched 15), 60-70
# (launched 55, from autograd's thread), 90-95 (launched 85)
STEP = [
    ("user_annotation", "tsod.micro_step", 0, 100, None),
    ("user_annotation", "tsod.train_forward", 0, 50, None),
    ("user_annotation", "tsod.backward", 50, 30, None),
    ("user_annotation", "tsod.update", 80, 20, None),
    ("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
    ("cuda_runtime", "cudaLaunchKernel", 15, 1, 2),
    ("cuda_driver", "cuLaunchKernel", 55, 1, 3),
    ("cuda_runtime", "cudaLaunchKernel", 85, 1, 4),
    ("kernel", "fwd", 5, 20, 1),
    ("kernel", "target", 30, 10, 2),
    ("kernel", "bwd", 60, 10, 3),
    ("kernel", "adamw", 90, 5, 4),
]


def _ctx(tl):
    return SimpleNamespace(timeline=tl, peaks=None, bounds=[], batch=2,
                           flops_per_image=1.0, rate=None)


@pytest.mark.parametrize("metric, events, want", [
    ("host_syncs.rate", BUCKET, 3),                  # 45, 65, 70; not 110
    ("post_process_idle_ms.rate", BUCKET, 0.035),   # 40-50, 55-80 of 40-90
    ("fetch_wait_ms.rate", BUCKET, 0.030),
    ("launches.rate", BUCKET, 4),
    ("launches.train", STEP, 4),
    ("forward_idle_ms.train", STEP, 0.020),          # 0-5, 25-30, 40-50
    ("backward_idle_ms.train", STEP, 0.020),         # 50-60, 70-80
])
def test_span_readers_on_a_known_trace(tmp_path, metric, events, want):
    """Each reader reads its known value, per bucket or micro-step, also
    over two of them, and None on the same slice without its spans."""
    read = spans.READERS[metric]
    assert read(_ctx(spans.SpanTimeline(_trace(tmp_path, events)))) == (
        pytest.approx(want))
    twice = events + [(c, n, ts + 1000, d, None if k is None else k + 100)
                      for c, n, ts, d, k in events]
    assert read(_ctx(spans.SpanTimeline(_trace(tmp_path, twice)))) == (
        pytest.approx(want))
    bare = [e for e in events if not e[1].startswith("tsod.")]
    assert read(_ctx(spans.SpanTimeline(_trace(tmp_path, bare)))) is None
    assert read(_ctx(Timeline(_trace(tmp_path, events)))) is None
    assert read(_ctx(None)) is None


def test_idle_gaps_put_down_to_the_innermost_span(tmp_path):
    """The gaps the benchmark's breakdown put down to ``bench.detect`` go to
    the program's ``tsod.post_process`` inside it."""
    tl = spans.SpanTimeline(_trace(tmp_path, BUCKET + [
        ("user_annotation", "bench.detect", 20, 70, None)]))
    # the gaps 0-10, 40-50, 55-80 and 110-200, by their middles
    assert dict(tl.idle_gaps_by_span()) == {
        "tsod.features": pytest.approx(10e-6),
        "tsod.post_process": pytest.approx(35e-6),
        "host_outside_ranges": pytest.approx(90e-6)}
    assert dict(tl.idle_gaps_by_range()) == {
        "bench.detect": pytest.approx(35e-6),
        "host_outside_ranges": pytest.approx(100e-6)}


# the benchmark's own ranges over BUCKET and STEP's times
BENCH = [
    ("user_annotation", "bench.predict:3", 0, 140, None),
    ("user_annotation", "bench.features", 0, 20, None),
    ("user_annotation", "bench.detect", 20, 70, None),
    ("user_annotation", "bench.roi_head", 30, 10, None),
]
BENCH_STEP = [
    ("user_annotation", "bench.micro_step", 0, 100, None),
    ("user_annotation", "bench.train_forward", 0, 50, None),
    ("user_annotation", "bench.anchor_target", 10, 10, None),
]
OLD_READERS = (readers.post_process_ms, readers.features_ms,
               readers.forward_ms, readers.backward_update_ms,
               readers.targets_ms, readers.kernel_roofline, readers.mfu,
               readers.idle_share)


@pytest.mark.parametrize("events", [BUCKET + BENCH, STEP + BENCH_STEP])
def test_old_readers_read_the_same_beside_program_spans(tmp_path, events):
    """Every reader the benchmark had reads the same value on a slice that
    also holds ``tsod.*`` ranges, through a ``Timeline`` or a
    ``SpanTimeline``; the ``Timeline``'s ranges and breakdown stay its
    own."""
    bare = [e for e in events if not e[1].startswith("tsod.")]
    peaks = {"bf16_flops": 1e12}
    tls = [Timeline(_trace(tmp_path, bare, "bare.json")),
           Timeline(_trace(tmp_path, events, "full.json")),
           spans.SpanTimeline(_trace(tmp_path, events, "full.json"))]
    ctxs = [SimpleNamespace(timeline=tl, peaks=peaks, batch=2, rate=2e4,
                            flops_per_image=1e3, bounds=[(0.001, 0.004)])
            for tl in tls]
    assert sum(fn(ctxs[0]) is not None for fn in OLD_READERS) >= 5
    for fn in OLD_READERS:
        want = fn(ctxs[0])
        assert [fn(c) for c in ctxs[1:]] == [want, want], fn
    for tl in tls[1:]:
        assert tl.ranges == tls[0].ranges
        assert tl.idle_gaps_by_range() == tls[0].idle_gaps_by_range()
        assert tl.device_ops_by_name() == tls[0].device_ops_by_name()
