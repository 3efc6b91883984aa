"""PyTorch port, the evaluator against the JAX package's: both ported
models at 64x64 (the tiny recipe of the other port tests, the
flagship with a 32-channel pyramid), JAX-initialised variables carried into
the port (``utils/jax_weights.py``), ``evaluate_sweep`` in both protocols
over the same loader's batches, and the ``collect_predictions`` result that
it scored, in float32 on the CPU.  The JAX single-scale detector runs ``pallas="on"``
(its whole-table proposal kernel, interpreted), the route the port takes.

- Predictions: the same detections per image, labels equal, boxes within
  the port's box tolerance (1e-4 + 1e-4 * |box|, ROADMAP.md section 3),
  scores within 1e-5;
- ``eval_loss`` within 1e-5 relative;
- every mAP within 1e-6.  That needs both packages to take every matching
  decision alike, so the test first asserts the margin: no prediction's IoU
  with a GT of its class lies within 1e-3 of a sweep threshold, and no two
  scores of one class are closer than the scores' largest difference
  between the packages (which would let the ranking differ).
"""

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.eval import evaluator as j_evaluator
from two_stage_object_detection_tpu.nets.trainer import (
    create_train_state as j_create_train_state)
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.coco import load_coco
from two_stage_object_detection_tpu_torch.data.pipeline import (
    DetectionDataset, Loader)
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.eval import evaluator
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.trainer import (
    TrainState, make_optimizer)
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

TINY = dict(input_size=(64, 64), num_classes=3, batch_size=2, max_gt_boxes=4,
            n_train_pre_nms=128, n_train_post_nms=32, n_test_pre_nms=64,
            n_test_post_nms=16, roi_n_sample=8, rpn_n_sample=32,
            max_detections=8, grad_accum_steps=2, compute_dtype="float32")
MODELS = {"single_scale": dict(TINY),
          "flagship": dict(TINY, fpn=True, backbone="resnet50",
                           loc_normalize=True, fpn_channels=32, fpn_fc_dim=64)}
JAX_EXTRA = {"single_scale": dict(pallas="on"), "flagship": {}}
THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Three eval batches of a synthetic root, as the loader yields them."""
    root = str(tmp_path_factory.mktemp("coco"))
    ann, img_dir = generate_synthetic_coco(
        root, split="val2017", num_images=6, num_classes=3,
        image_size=(64, 64), max_boxes=3, seed=11)
    ds = DetectionDataset(load_coco(ann, img_dir), (64, 64), max_gt=4,
                          train=False)
    loader = Loader(ds, 2, shuffle=False, num_workers=1)
    try:
        return list(loader)
    finally:
        loader.close()


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """The JAX train state (flax-initialised) and the port's, carrying the
    same variables."""
    name = request.param
    jcfg = JConfig(**MODELS[name], **JAX_EXTRA[name])
    _, jstate = j_create_train_state(jcfg, jax.random.PRNGKey(0),
                                     init_image_size=(64, 64))
    cfg = Config(**MODELS[name], device="cpu")
    model = FasterRCNN(cfg, device="cpu")
    load_jax_variables(model, unfreeze(jax.device_get(jstate.params)),
                       unfreeze(jax.device_get(jstate.batch_stats)))
    state = TrainState(cfg, model, *make_optimizer(cfg, model.parameters()))
    return cfg, state, jcfg, jstate


def _iou(a, b):
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _sweep_and_predictions(module, state, batches, cfg, use_predict):
    """``module.evaluate_sweep`` over the batches, and the
    ``collect_predictions`` result that it scored: one device pass."""
    seen = []
    collect = module.collect_predictions

    def record(*args, **kw):
        seen.append(collect(*args, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "collect_predictions", record)
        sweep = module.evaluate_sweep(state, lambda: iter(batches), cfg,
                                      use_predict=use_predict)
    (collected,) = seen
    return sweep, collected


@pytest.mark.parametrize("use_predict", [False, True],
                         ids=["train_graph", "predict"])
def test_evaluate_sweep_matches_jax(pair, batches, use_predict):
    cfg, state, jcfg, jstate = pair
    sweep, (preds, gts, loss) = _sweep_and_predictions(
        evaluator, state, batches, cfg, use_predict)
    j_sweep, (j_preds, j_gts, j_loss) = _sweep_and_predictions(
        j_evaluator, jstate, batches, jcfg, use_predict)

    assert len(preds) == len(j_preds) == 6
    score_diff, n_det = 0.0, 0
    for i, ((b, s, l), (jb, js, jl)) in enumerate(zip(preds, j_preds)):
        assert len(b) == len(jb), f"image {i}: {len(b)} vs {len(jb)}"
        np.testing.assert_array_equal(l, jl, err_msg=f"image {i}")
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-4,
                                   err_msg=f"image {i}")
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-5,
                                   err_msg=f"image {i}")
        score_diff = max(score_diff, float(np.abs(s - js).max(initial=0.0)))
        n_det += len(b)
    for (g, gl), (jg, jgl) in zip(gts, j_gts):
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(gl, jgl)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5, atol=0)
    assert n_det > 0 and (use_predict or loss > 0)

    # the margin that makes every matching decision the same on both sides
    ious, gaps = [], []
    for c in range(1, cfg.num_classes + 1):
        s_c = np.sort(np.concatenate([s[l == c] for _, s, l in preds]))
        gaps += list(np.diff(s_c))
        for (b, _, l), (g, gl) in zip(preds, gts):
            ious += list(_iou(b[l == c].astype(np.float64),
                              g[gl == c].astype(np.float64)).ravel())
    ious = np.asarray(ious)
    margin = np.abs(ious[:, None] - np.asarray(THRESHOLDS)[None]).min(
        initial=1.0)
    assert margin >= 1e-3, margin
    assert min(gaps, default=1.0) > score_diff, (min(gaps), score_diff)

    assert set(sweep) == set(j_sweep)
    for k in ("mAP50", "mAP95", "mAP50_95"):
        assert 0.0 <= sweep[k] <= 1.0
        assert abs(sweep[k] - j_sweep[k]) <= 1e-6, (k, sweep[k], j_sweep[k])
    np.testing.assert_allclose(sweep["eval_loss"], j_sweep["eval_loss"],
                               rtol=1e-5, atol=0)
    if not use_predict:
        # the trainer graph's sampled rois include the GT boxes: some match
        assert (ious >= 0.5).any() and sweep["mAP50"] > 0.0
