"""PyTorch port, the RoI pooling routes without a hand kernel: the
matrix-product RoIAlign (``roi_align_mm``) and the masked mean
(``roi_pool_mean``), the single-scale ``RoIHead`` in its ``align`` and
``mean`` modes, the dense route of ``FPNRoIHead`` (``fpn_roi_window=0``),
and the three detectors that take them, against the JAX package in float32
on the CPU.

In the JAX package these are plain matrix products outside any Pallas
kernel, so the port's are plain PyTorch too, differentiated by autograd.

Tolerances: the ops and heads, forward and gradient, within 1e-5 (values
of order 1; the two packages sum the same products in another order).  The
detectors reuse the checks of ``tests/test_torch_train.py`` (the gradient
leaves within 1e-3 of their largest magnitude, on weights settled off every
decision) and ``tests/test_torch_detector.py`` (boxes within 1e-4 + 1e-4 *
|box| px, scores within 1e-4, valid and labels equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from test_torch_train import ROUTES, Pair, check_train_forward_and_gradients
from two_stage_object_detection_tpu.nets import fpn as jfpn
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu.nets.roi_head import RoIHead as JRoIHead
from two_stage_object_detection_tpu.ops.roi_pool import (
    roi_align_mm as j_roi_align_mm, roi_pool_mean as j_roi_pool_mean)
from two_stage_object_detection_tpu_torch.nets import fpn as tfpn
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.roi_head import RoIHead
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_align_mm, roi_pool_mean)
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

T = torch.from_numpy
OPS = {"align": (j_roi_align_mm, roi_align_mm),
       "mean": (j_roi_pool_mean, roi_pool_mean)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rois(rng, b, r, img_hw, edge_cases=True):
    """``[b, r, 4]`` xyxy rois in image coordinates: random ones, and (with
    ``edge_cases``) a degenerate one (x2 < x1), a zero-size one, one
    half off the map, one wholly off it, a sub-pixel one and a long thin
    one."""
    h, w = img_hw
    xy = rng.rand(b, r, 2) * np.array([w, h]) * 0.8
    rois = np.concatenate([xy, xy + rng.rand(b, r, 2) * np.array([w, h]) * 0.5
                           + 1.0], -1)
    if edge_cases:
        rois[:, 0] = [0.6 * w, 0.2 * h, 0.3 * w, 0.7 * h]
        rois[:, 1] = [0.5 * w, 0.5 * h, 0.5 * w, 0.5 * h]
        rois[:, 2] = [-0.3 * w, 0.6 * h, 0.2 * w, 1.4 * h]
        rois[:, 3] = [1.2 * w, -0.5 * h, 1.6 * w, -0.1 * h]
        rois[:, 4] = [0.41 * w, 0.52 * h, 0.41 * w + 0.3, 0.52 * h + 0.2]
        rois[:, 5] = [0.05 * w, 0.4 * h, 0.95 * w, 0.4 * h + 3.0]
    return rois.astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("op", list(OPS))
def test_pooling_op_and_gradient_match_jax(op, scale):
    """``roi_align_mm`` / ``roi_pool_mean`` on ``[B, H, W, C]`` maps (the
    JAX function vmapped over images) with the edge-case rois of
    ``_rois``: the pooled values, and the map's gradient of ``sum(out *
    g)`` (``jax.grad`` against autograd), within 1e-5.  The mean's empty
    bins (rois off the map) are 0 on both sides."""
    rng = np.random.RandomState(7)
    jfn, tfn = OPS[op]
    feats = rng.randn(2, 12, 10, 8).astype(np.float32)
    rois = _rois(rng, 2, 16, (12 / scale, 10 / scale))
    g = rng.randn(2, 16, 7, 7, 8).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda fi, ri: jfn(fi, ri, 7, scale))(f, rois)
        return jnp.sum(out * g), out

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        feats)
    f = T(feats).requires_grad_(True)
    got = tfn(f, T(rois), 7, scale)
    (got * T(g)).sum().backward()
    assert got.shape == (2, 16, 7, 7, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5)
    if op == "mean":
        assert (np.asarray(want)[:, 3] == 0).all()          # off the map
        assert (got.detach().numpy()[:, 3] == 0).all()
    # one image alone is the same as the batch's first
    one = tfn(T(feats[0]), T(rois[0]), 7, scale)
    np.testing.assert_array_equal(one.detach().numpy(),
                                  got.detach().numpy()[0])


@pytest.mark.parametrize("mode", ["align", "mean"])
def test_roi_head_matches_flax(mode):
    """``RoIHead(align|mean)`` on a non-square map and image (scale to the
    map, pool, mean over the bins, two dense heads): outputs and the map's
    gradient within 1e-5."""
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 8, 10, 16).astype(np.float32)
    rois = _rois(rng, 2, 12, (128, 160))
    jm = JRoIHead(n_class=4, roi_size=7, pool_mode=mode)
    v = unfreeze(jm.init(jax.random.PRNGKey(0), feats, rois, (128, 160)))
    gl = rng.randn(2, 12, 16).astype(np.float32)
    gs = rng.randn(2, 12, 4).astype(np.float32)

    def loss(f):
        locs, scores = jm.apply(v, f, rois, (128, 160))
        return jnp.sum(locs * gl) + jnp.sum(scores * gs), (locs, scores)

    (_, want), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(feats)
    head = RoIHead(4, 16, 7, pool_mode=mode)
    load_jax_variables(head, jax.tree.map(np.asarray, v["params"]))
    x = T(feats).permute(0, 3, 1, 2).requires_grad_(True)
    got = head(x, T(rois), (128, 160))
    ((got[0] * T(gl)).sum() + (got[1] * T(gs)).sum()).backward()
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jgrad), rtol=0, atol=1e-5)


def test_fpn_roi_head_dense_matches_flax():
    """``FPNRoIHead(window=0)``: eq.-1 levels without the span-aware bump
    (the long thin rois would be bumped on the windowed route), every level
    pooled with ``roi_align_mm`` and blended by the one-hot level, fc1 over
    (p, q, c), fc2, cls_loc/score: outputs and every level's gradient
    within 1e-5; ``use_window=False`` (the train route) is the same
    function."""
    rng = np.random.RandomState(8)
    c, img = 16, (64, 64)
    pyr = [rng.rand(2, s, s, c).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    rois = _rois(rng, 2, 14, img)
    rois[:, 6] = [-40.0, 20.0, 100.0, 23.0]     # 35 cells long at P2
    jhead = jfpn.FPNRoIHead(n_class=4, fc_dim=32, window=0, pallas="off")
    v = unfreeze(jhead.init(jax.random.PRNGKey(0), pyr, rois, img))
    gl = rng.randn(2, 14, 16).astype(np.float32)
    gs = rng.randn(2, 14, 4).astype(np.float32)

    def loss(levels):
        locs, scores = jhead.apply(v, levels, rois, img)
        return jnp.sum(locs * gl) + jnp.sum(scores * gs), (locs, scores)

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(pyr)
    thead = tfpn.FPNRoIHead(4, channels=c, fc_dim=32, window=0)
    load_jax_variables(thead, jax.tree.map(np.asarray, v["params"]))
    levels = tfpn.fpn_level_assign(T(rois), 2, 5)
    scales = tuple((s / 64, s / 64) for s in (16, 8, 4, 2))
    bumped = tfpn.span_aware_levels(T(rois), levels - 2, scales, 30.0)
    assert bool((bumped > levels - 2).any())           # a bump was skipped
    xs = [T(p).permute(0, 3, 1, 2).requires_grad_(True) for p in pyr]
    got = thead(xs, T(rois), img)
    ((got[0] * T(gl)).sum() + (got[1] * T(gs)).sum()).backward()
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    for li, (x, jg) in enumerate(zip(xs[:4], jgrads[:4])):
        np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jg), rtol=0, atol=1e-5,
                                   err_msg=f"level {li}")
    assert xs[4].grad is None and not np.asarray(jgrads[4]).any()
    with torch.no_grad():
        train_route = thead(xs, T(rois), img, use_window=False)
    assert all(torch.equal(a, b.detach()) for a, b in zip(train_route, got))


# ------------------------------------------------------------- detectors
@pytest.fixture(scope="module", params=list(ROUTES))
def route_pair(request):
    return Pair(request.param)


def test_route_predict_matches_jax(route_pair):
    """``predict`` at 64x64 with ``score_thresh=0`` on the route's seeded
    weights: valid and labels equal, scores within 1e-4, boxes within 1e-4
    + 1e-4 * |box| px (the tolerance of
    ``tests/test_torch_detector.py::test_predict_matches_jax``)."""
    p = route_pair
    jm = JFasterRCNN(p.jcfg.replace(score_thresh=0.0))
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="predict"))(
        {"params": p.params, "batch_stats": p.stats}, x)
    model = load_jax_variables(
        FasterRCNN(p.cfg.replace(score_thresh=0.0), device="cpu"), p.params,
        p.stats)
    got = model.predict(T(x))
    wb, ws, wl, wv = (np.asarray(a) for a in want)
    gb, gs, gl, gv = (t.numpy() for t in got)
    assert gv.sum() > 0, "no detections to compare"
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)


def test_route_train_forward_and_gradients_match_jax(route_pair):
    """``train_forward(train=True)`` + backward of the route's detector:
    the checks and tolerances of
    ``tests/test_torch_train.py::test_train_forward_and_gradients_match_jax``."""
    check_train_forward_and_gradients(route_pair)
