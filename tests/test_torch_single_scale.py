"""PyTorch port, the single-scale detector of the default ``Config()``
(HarDNet-39 reference layout, ``fpn=False``, RoIPool max): its RPN and RoI
heads, the whole ``predict`` and the ``Predictor`` against the JAX package,
in float32 on the CPU, where the port runs the plain versions of its kernels.

The JAX side runs ``Config(pallas="on", pallas_roi=False)``: ``pallas="on"``
makes its CPU predict take the whole-table proposal kernel (kernel 3,
interpreted), the route the port takes; ``pallas_roi=False`` keeps its RoI
head on the masked-max ``roi_pool``, since its RoIPool kernel is called
without ``interpret`` and cannot run on the CPU.  Max is exact, so the two
JAX pooling routes give the same values.

Weights: the variable trees get their shapes from ``jax.eval_shape`` of the
flax init (a compiled flax init of the whole detector takes ~20 s here) and
seeded numpy values -- fan-in-scaled kernels, randomised batch-norm leaves
-- which ``load_jax_variables`` carries across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu.nets.roi_head import RoIHead as JRoIHead
from two_stage_object_detection_tpu.nets.rpn import RPNHead as JRPNHead
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.roi_head import RoIHead
from two_stage_object_detection_tpu_torch.nets.rpn import RPNHead
from two_stage_object_detection_tpu_torch.serving import FIELDS, Predictor
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

# 128x128 -> an 8x8 map, 576 anchors: 6 * 3000 > 576, the whole-table route
KW = dict(input_size=(128, 128), num_classes=3, n_test_post_nms=16,
          max_detections=8, score_thresh=0.0, compute_dtype="float32")
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """Seeded numpy values for a flax variable tree of ``ShapeDtypeStruct``s:
    kernels ~ N(0, 1/fan_in), biases and batch-norm mean ~ 0.1 N(0, 1),
    batch-norm scale and var ~ U(0.5, 1.5)."""
    out = {}
    for k, v in shapes.items():
        if not hasattr(v, "shape"):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def _variables(module, *args):
    shapes = unfreeze(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(0)
    return {k: _fill(v, rng) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def carried():
    jm = JFasterRCNN(JConfig(**KW, pallas="on", pallas_roi=False))
    v = _variables(jm, jnp.zeros((1, 128, 128, 3)))
    # small RPN deltas, so proposals stay inside the image and overlap
    v["params"]["rpn_head"]["loc"]["kernel"] *= 0.1
    pred = Predictor.from_jax_variables(Config(**KW), v["params"],
                                        v["batch_stats"], device="cpu",
                                        batch_sizes=(1, 2))
    return jm, v, pred


def test_single_scale_predict_matches_jax(carried):
    """Equal ``valid`` and ``labels``; scores <= 1e-4 absolute; boxes
    within 1e-4 + 1e-4 * |box| px (the decode scales the RPN deltas' f32
    summation-order noise by the anchor side, as in
    ``test_torch_detector.py::test_predict_matches_jax``)."""
    jm, v, pred = carried
    x = np.random.RandomState(3).rand(2, 128, 128, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="predict"))(v, x)
    got = pred.model.predict(T(x))
    wb, ws, wl, wv = (np.asarray(a) for a in want)
    gb, gs, gl, gv = (t.numpy() for t in got)
    assert gv.sum() >= 8, "too few detections to compare"
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)
    assert gb.shape == (2, 8, 4) and gl.dtype == np.int32


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_single_scale_predictor_matches_direct_predict(carried, wire):
    """Buckets (1, 2) answer 1- and 3-image requests with the arrays of a
    direct ``predict``: equal valid/labels, scores <= 1e-5, boxes <= 1e-5 +
    1e-5 * |box| px (another batch size may sum the convs in another order)."""
    _, _, pred = carried
    server = Predictor(pred.cfg, pred.model, batch_sizes=(1, 2), wire=wire)
    x = np.random.RandomState(4).rand(3, 128, 128, 3).astype(np.float32)
    if wire == "u8":
        req = np.round(x * 255).astype(np.uint8)
        x = req.astype(np.float32) / 255.0
    else:
        req = x
    for n in (1, 3):
        out = server(req[:n])
        direct = [t.numpy() for t in pred.model.predict(T(x[:n]))]
        assert set(out) == set(FIELDS)
        for name, d in zip(FIELDS, direct):
            assert out[name].shape == d.shape
            if name in ("labels", "valid"):
                np.testing.assert_array_equal(out[name], d)
            else:
                np.testing.assert_allclose(out[name], d, atol=1e-5,
                                           rtol=1e-5 if name == "boxes" else 0)


def test_rpn_head_matches_flax():
    """``RPNHead`` on a non-square map: the same [B, H*W*A, 4/2] rows in
    the anchor order (NHWC flattening), <= 1e-5."""
    feats = np.random.RandomState(5).randn(2, 5, 7, 16).astype(np.float32)
    jm = JRPNHead(n_anchors=9)
    v = _variables(jm, feats)
    want = jm.apply(v, feats)
    head = RPNHead(9, 16)
    load_jax_variables(head, v["params"])
    got = head(T(feats).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 5 * 7 * 9, g.shape[-1])
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_roi_head_pool_matches_flax():
    """``RoIHead`` in ``pool`` mode on a non-square map and image: scale to
    the map, RoIPool max, mean over the bins, two dense heads; <= 1e-5."""
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 8, 10, 16).astype(np.float32)
    xy = rng.rand(2, 12, 2) * np.array([160, 128])
    rois = np.concatenate([xy, xy + rng.rand(2, 12, 2) * 80 + 4],
                          -1).astype(np.float32)
    jm = JRoIHead(n_class=4, roi_size=7, pool_mode="pool")
    v = _variables(jm, feats, rois, (128, 160))
    want = jm.apply(v, feats, rois, (128, 160))
    head = RoIHead(4, 16, 7)
    load_jax_variables(head, v["params"])
    with torch.no_grad():
        got = head(T(feats).permute(0, 3, 1, 2), T(rois), (128, 160))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_default_config_builds_loads_and_needs_a_gpu(monkeypatch):
    """``Config()`` is this path (hardnet39, single-scale, 38x38 map, 12,996
    anchors): every leaf of its full flax variable tree is carried across
    and no port variable is left unfilled; with no GPU, the default
    ``device="cuda"`` raises."""
    cfg = Config(device="cpu")
    assert (cfg.backbone, cfg.fpn, cfg.roi_pool_mode) == ("hardnet39", False,
                                                         "pool")
    model = FasterRCNN(cfg)
    assert model.anchors.shape == (12996, 4)
    shapes = unfreeze(jax.eval_shape(JFasterRCNN(JConfig()).init,
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, 600, 600, 3))))
    rng = np.random.RandomState(1)
    load_jax_variables(model, _fill(shapes["params"], rng),
                       _fill(shapes["batch_stats"], rng))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FasterRCNN(Config())
