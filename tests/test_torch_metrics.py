"""PyTorch port, the detection metrics against the JAX package's: seeded
random scenes through both packages' ``compute_map``,
``compute_map_sweep``, ``compute_coco_summary``, ``filter_pr`` /
``compute_ap`` and the evaluator's ``_per_class_nms_host`` give equal
outputs (the same numpy code on the same inputs: exact equality)."""

import numpy as np
import pytest

from two_stage_object_detection_tpu.eval import evaluator as j_evaluator
from two_stage_object_detection_tpu.eval import metrics as j_metrics
from two_stage_object_detection_tpu_torch.eval import evaluator, metrics


def _scene(rng, n_images=10, num_classes=4):
    """Per-image predictions near (and away from) the GTs, some images
    without GT or predictions, boxes of every COCO area bin."""
    preds, gts = [], []
    for _ in range(n_images):
        m = rng.randint(0, 6)
        xy = rng.rand(m, 2) * 300
        side = rng.choice([12.0, 60.0, 200.0], size=(m, 1)) * rng.uniform(
            0.7, 1.3, size=(m, 2))
        g = np.concatenate([xy, xy + side], -1).astype(np.float32)
        gl = rng.randint(1, num_classes + 1, m)
        n_near = rng.randint(0, 2 * m + 1)
        src = rng.randint(0, max(m, 1), n_near)
        near = (g[src] + rng.randn(n_near, 4) * 6).astype(np.float32) if m \
            else np.zeros((0, 4), np.float32)
        n_far = rng.randint(0, 5)
        fxy = rng.rand(n_far, 2) * 300
        far = np.concatenate([fxy, fxy + rng.rand(n_far, 2) * 80 + 4], -1)
        p = np.concatenate([near, far.astype(np.float32)])
        pl = np.concatenate([gl[src] if m else np.zeros(0, int),
                             rng.randint(1, num_classes + 1, n_far)])
        flip = rng.rand(len(pl)) < 0.15           # some wrong classes
        pl = np.where(flip, rng.randint(1, num_classes + 1, len(pl)), pl)
        s = rng.rand(len(p)).astype(np.float32)
        preds.append((p, s, pl.astype(np.int64)))
        gts.append((g, gl.astype(np.int64)))
    return preds, gts


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), where


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_sweep_and_coco_summary_equal_jax(seed):
    rng = np.random.RandomState(seed)
    preds, gts = _scene(rng)
    for t in (0.5, 0.75, 0.95):
        _same(metrics.compute_map(preds, gts, 4, iou_threshold=t),
              j_metrics.compute_map(preds, gts, 4, iou_threshold=t), f"@{t}")
    th = tuple(np.arange(0.5, 1.0, 0.05))
    sweep = metrics.compute_map_sweep(preds, gts, 4, th)
    _same(sweep, j_metrics.compute_map_sweep(preds, gts, 4, th))
    assert max(sweep.values()) > 0.0
    _same(metrics.compute_coco_summary(preds, gts, 4),
          j_metrics.compute_coco_summary(preds, gts, 4))
    _same(metrics.compute_coco_summary(preds, gts, 4, max_dets=(1, 3)),
          j_metrics.compute_coco_summary(preds, gts, 4, max_dets=(1, 3)))


def test_filter_pr_and_compute_ap_equal_jax():
    rng = np.random.RandomState(3)
    for n_gt in (1, 4, 9):
        n = rng.randint(1, 30)
        tp = np.cumsum(rng.rand(n) < 0.5)
        pr = np.stack([tp / np.arange(1, n + 1), tp / n_gt], -1)
        got = metrics.filter_pr(pr, n_gt)
        _same(got, j_metrics.filter_pr(pr, n_gt))
        _same(metrics.compute_ap(got), j_metrics.compute_ap(got))


def test_per_class_nms_host_equals_jax():
    """Crowded scenes with background rows, far-out unclipped boxes, every
    threshold the evaluator uses."""
    rng = np.random.RandomState(4)
    for trial in range(30):
        n = rng.randint(1, 80)
        xy = rng.rand(n, 2) * 400 - 50
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 100 + 1], -1)
        boxes = boxes.astype(np.float32)
        if trial % 5 == 0:
            boxes[: n // 4, 2:] += 3e4
        scores = rng.rand(n).astype(np.float32)
        labels = rng.randint(0, 4, n)
        for thr in (0.3, 0.5, 0.7):
            got = evaluator._per_class_nms_host(boxes, scores, labels, 3, thr)
            want = j_evaluator._per_class_nms_host(boxes, scores, labels, 3,
                                                   thr)
            _same(got, want, f"trial {trial} thr {thr}")
