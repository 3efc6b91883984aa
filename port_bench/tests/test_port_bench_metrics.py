"""The arithmetic of the metrics on made-up timelines and known shapes."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import compare, counts, readers
from port_bench.trace import Timeline

PEAKS = {"bf16_flops": 1e12, "f32_flops": 1e12, "hbm_bytes_per_s": 1e12}


def _timeline(tmp_path, events):
    """A Chrome trace of ``events``: ``(cat, name, ts, dur, corr)``."""
    out = []
    for cat, name, ts, dur, corr in events:
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "args": {} if corr is None else {"correlation": corr}}
        out.append(e)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": out}))
    return Timeline(str(path))


def _serving_trace(tmp_path):
    # host: predict:3 [0, 100] with features [0, 20], detect [20, 90] and
    # roi_head [30, 40] inside; kernels launched at 5, 10 (features), 35
    # (roi_head), 60 (post-process); the device runs them at 10-30, 30-40,
    # 50-55, 80-100; a memcpy 100-110; the slice is [0, 200]
    return _timeline(tmp_path, [
        ("user_annotation", "bench.predict:3", 0, 100, None),
        ("user_annotation", "bench.features", 0, 20, None),
        ("user_annotation", "bench.detect", 20, 70, None),
        ("user_annotation", "bench.roi_head", 30, 10, None),
        ("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
        ("cuda_runtime", "cudaLaunchKernel", 10, 1, 2),
        ("cuda_runtime", "cudaLaunchKernel", 35, 1, 3),
        ("cuda_runtime", "cudaLaunchKernel", 60, 1, 4),
        ("kernel", "conv_a", 10, 20, 1),
        ("kernel", "conv_b", 30, 10, 2),
        ("kernel", "windowed_align_kernel<float>", 50, 5, 3),
        ("kernel", "nms_step", 80, 20, 4),
        ("gpu_memcpy", "Memcpy DtoH", 100, 10, 5),
        ("cpu_op", "aten::empty", 0, 200, None),
    ])


def test_timeline_joins_kernels_to_ranges_by_correlation(tmp_path):
    tl = _serving_trace(tmp_path)
    assert tl.window_s == pytest.approx(200e-6)
    assert tl.busy_s == pytest.approx(65e-6)       # 10-40, 50-55, 80-110
    ctx = SimpleNamespace(timeline=tl, peaks=PEAKS, flops_per_image=2e3,
                          bounds=[(0.002, 0.004), (0.001, 0.006)],
                          rate=3 / 200e-6)
    # 65 us busy for 3 images, at 3 images an unprofiled 200 us
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 65 / 200))
    assert readers.features_ms(ctx) == pytest.approx(0.030)
    # end of detect's last kernel (100) - end of roi_head's last (55)
    assert readers.post_process_ms(ctx) == pytest.approx(0.045)
    # 3 images x 2e3 FLOP an unprofiled 200 us at 1e12
    assert readers.mfu(ctx) == pytest.approx(100 * 6e3 / 200e-6 / 1e12)
    assert readers.kernel_roofline(ctx) == pytest.approx(30.0)
    gaps = dict(tl.idle_gaps_by_range())
    assert gaps["bench.detect"] == pytest.approx(35e-6)      # 55-80
    assert gaps["host_outside_ranges"] == pytest.approx(90e-6)
    assert tl.device_ops_by_name()[0][0] == "conv_a"


def test_train_readers_split_forward_targets_and_backward(tmp_path):
    tl = _timeline(tmp_path, [
        ("user_annotation", "bench.micro_step", 0, 100, None),
        ("user_annotation", "bench.train_forward", 0, 50, None),
        ("user_annotation", "bench.anchor_target", 10, 10, None),
        ("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
        ("cuda_runtime", "cudaLaunchKernel", 15, 1, 2),
        ("cuda_driver", "cuLaunchKernel", 60, 1, 3),
        ("kernel", "fwd", 5, 20, 1),
        ("kernel", "target", 25, 4, 2),
        ("kernel", "bwd", 60, 30, 3),
    ])
    ctx = SimpleNamespace(timeline=tl, peaks=PEAKS, flops_per_image=1e3,
                          batch=4, bounds=[], rate=4 / 100e-6)
    assert readers.forward_ms(ctx) == pytest.approx(0.020)
    assert readers.targets_ms(ctx) == pytest.approx(0.004)
    assert readers.backward_update_ms(ctx) == pytest.approx(0.030)
    assert readers.mfu(ctx) == pytest.approx(100 * 4e3 / 100e-6 / 1e12)
    # 54 us of kernels for the micro-step's 4 images, 4 images a 100 us
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 54 / 100))
    assert readers.kernel_roofline(ctx) is None     # nothing to read


def test_readers_find_nothing_without_a_slice():
    ctx = SimpleNamespace(timeline=None, peaks=PEAKS, flops_per_image=1.0,
                          bounds=[], batch=1, rate=None)
    for fn in (readers.idle_share, readers.mfu, readers.features_ms,
               readers.post_process_ms, readers.forward_ms,
               readers.kernel_roofline):
        assert fn(ctx) is None


def _want(boxes, scores, labels):
    """A reference output whose candidates are its own detections: one
    proposal a detection, its decode for every one of 3 classes."""
    n = len(scores)
    cand_boxes = np.repeat(np.asarray(boxes, np.float32)[:, None], 3, 1)
    cand_scores = np.zeros((n, 3), np.float32)
    cand_scores[np.arange(n), np.asarray(labels) - 1] = scores
    return {"boxes": np.asarray(boxes, np.float32),
            "scores": np.asarray(scores, np.float32),
            "labels": np.asarray(labels), "valid": np.ones(n, bool),
            "cand_boxes": cand_boxes, "cand_scores": cand_scores,
            "cand_valid": np.ones(n, bool)}


def test_scored_detections_zero_when_equal_one_when_altered_or_dropped():
    want = _want([[0, 0, 10, 10], [20, 20, 40, 40]], [0.9, 0.5], [1, 2])
    same = {k: want[k] for k in ("boxes", "scores", "labels", "valid")}
    r = compare.scored_detections([(same, want)])
    assert r["miss_share"] == 0.0 and r["found"] == 2
    moved = dict(same, boxes=same["boxes"] + 15.0)         # not found
    assert compare.scored_detections([(moved, want)])["miss_share"] == (
        pytest.approx(1.0))
    relabel = dict(same, labels=np.array([2, 1]))           # found, scored 0
    assert compare.scored_detections([(relabel, want)])["miss_share"] == (
        pytest.approx(1.0))
    dropped = dict(same, valid=np.array([True, False]))     # mass short
    r = compare.scored_detections([(dropped, want)])
    assert r["miss_share"] == pytest.approx(0.5 / 1.4)
    nudged = dict(same, scores=np.array([0.8, 0.5], np.float32))
    r = compare.scored_detections([(nudged, want)])
    assert r["score_gap"] == pytest.approx(0.05)
    assert r["miss_share"] == pytest.approx((0.1 + 0.1) / 1.4)


def test_worst_leaf_gap_against_the_larger_of_leaf_and_median():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 0.5}
    gap, leaf = compare.worst_leaf_gap(got, want)
    assert leaf == "c" and gap == pytest.approx(0.5)
    assert compare.moving_leaves(want) == ["a", "b"]


def test_leaf_errors_see_direction_where_norms_agree():
    import torch
    want = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0]),
            "c": torch.tensor([0.0, 1e-9])}
    got = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([1.0, 0.0]),
           "c": torch.tensor([0.0, 0.0])}
    err = compare.leaf_errors(got, want, ["a", "b", "c"])
    # a: same norm, turned: |(1, -1)| / 5; c: against the median leaf (1)
    assert err["a"] == pytest.approx(2 ** 0.5 / 5)
    assert err["b"] == 0.0 and err["c"] == pytest.approx(1e-9)
    assert compare.leaf_errors({}, want, ["a"])["a"] == pytest.approx(1.0)
    norms = compare.leaf_norms(want)
    assert norms["a"] == pytest.approx(5.0)
    assert compare.worst_leaf_gap(compare.leaf_norms(got), norms,
                                  ["a", "b"])[0] == 0.0


def test_flops_count_known_shapes():
    from port_bench.reference.config import Config
    cfg = Config(input_size=(64, 64), num_classes=3, n_test_post_nms=16,
                 roi_n_sample=8)
    fwd = counts.model_flops(cfg, train=False)
    train = counts.model_flops(cfg, train=True)
    # the box head of the single scale: two dense layers on 16 rois
    head = 2 * 16 * 512 * (4 * 4 + 4)
    assert fwd > head and 2.0 * fwd < train < 3.0 * fwd + 1e9


def test_kernel_bounds_from_counts():
    import torch
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]]],
                         dtype=torch.float32)
    out = boxes[:, [0, 2]]
    valid = torch.tensor([[True, True]])
    ms = counts.nms_bound_ms(boxes, out, valid, 2, PEAKS)
    nbytes = 3 * 20 + 2 * 21
    ops = (2 + 0) * counts.IOU_FLOPS + 3 * 3
    assert ms == pytest.approx(max(nbytes, ops) / 1e12 * 1e3)
    feats = torch.zeros((1, 8, 8, 4))
    rois = torch.tensor([[[0.0, 0.0, 6.0, 6.0]]])
    px = counts.bin_pixels(rois, 8, 8, 2)
    assert 0 < px <= 4 * 4 * 4          # 2x2 bins of a 6-pixel roi
    ms = counts.roi_pool_bound_ms(feats, rois, 2, 4, PEAKS)
    assert ms == pytest.approx(max(1 * 8 * 8 * 4 * 4 + 4 * 4 + 16 * 4,
                                   px * 4) / 1e12 * 1e3)
