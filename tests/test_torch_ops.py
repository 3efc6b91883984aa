"""PyTorch port, ops: geometry, anchors, NMS, proposals (kernel 1's plain
version) and windowed RoIAlign (kernel 2's plain version) against the JAX
package, in float32 on the CPU.

The JAX Pallas kernels run interpreted (``interpret=True``), as the JAX
package's own tests run them.  The CUDA kernels cannot run here; they are
held against these plain versions on the GPU (``tests/test_torch_kernels.py``
and ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.fpn import fpn_level_assign as j_level
from two_stage_object_detection_tpu.nets.rpn import (
    create_proposals as j_create_proposals)
from two_stage_object_detection_tpu.ops.pallas_proposals import (
    _truncated_nms_call)
from two_stage_object_detection_tpu.ops.pallas_windowed_align import (
    windowed_roi_align_batched as j_windowed)
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.rpn import (
    create_proposals as t_create_proposals)
from two_stage_object_detection_tpu_torch.ops import anchors as ta
from two_stage_object_detection_tpu_torch.ops import geometry as tg
from two_stage_object_detection_tpu_torch.ops import nms as tn
from two_stage_object_detection_tpu_torch.ops import roi_pool as tr
from two_stage_object_detection_tpu_torch.ops.proposals import (
    greedy_nms, greedy_nms_rows_reference, proposals_batched)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    windowed_roi_align_batched)
from two_stage_object_detection_tpu_torch.utils.profiling import counters

# the JAX package's ops/__init__ re-exports functions named like modules
ja = importlib.import_module("two_stage_object_detection_tpu.ops.anchors")
jg = importlib.import_module("two_stage_object_detection_tpu.ops.geometry")
jn = importlib.import_module("two_stage_object_detection_tpu.ops.nms")
jr = importlib.import_module("two_stage_object_detection_tpu.ops.roi_pool")
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, *lead, size=100.0):
    xy = rng.rand(*lead, 2) * size
    wh = rng.rand(*lead, 2) * size / 2 + 1.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------ geometry
def test_geometry_matches_jax(rng):
    """bbox_iou / loc2bbox (strided [R, C*4]) / bbox2loc / clip_boxes /
    xywh2xyxy: <= 1e-5 (float32 transcendental ulps)."""
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    loc = (rng.randn(7, 12) * 0.5).astype(np.float32)
    cases = [
        (jg.bbox_iou(a, b), tg.bbox_iou(T(a), T(b))),
        (jg.box_area(a), tg.box_area(T(a))),
        (jg.loc2bbox(a, loc), tg.loc2bbox(T(a), T(loc))),
        (jg.bbox2loc(a, a[::-1].copy()), tg.bbox2loc(T(a), T(a[::-1].copy()))),
        (jg.clip_boxes(a * 2 - 30, (60, 80)), tg.clip_boxes(T(a * 2 - 30), (60, 80))),
        (jg.xywh2xyxy(a), tg.xywh2xyxy(T(a))),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert tg.xywh2xyxy([1, 2, 3, 4]) == jg.xywh2xyxy([1, 2, 3, 4])


# ------------------------------------------------------------- anchors
def test_device_constant_is_one_shared_tensor_per_device():
    """``device_constant``: the values exactly, one tensor per ``(values,
    dtype, device)`` however the device is spelled, another per dtype, and
    made outside inference mode even when first asked for inside it."""
    a = tg.device_constant([0.1, 0.2], torch.float32, "cpu")
    assert a is tg.device_constant((0.1, 0.2), torch.float32,
                                   torch.device("cpu"))
    assert torch.equal(a, torch.tensor([0.1, 0.2]))
    b = tg.device_constant([0.1, 0.2], torch.float64, "cpu")
    assert b is not a and b.dtype == torch.float64
    with torch.inference_mode():
        c = tg.device_constant([0.125], torch.float32, "cpu")
    assert not c.is_inference()


def test_fpn_anchor_table_equals_jax_at_600():
    kw = dict(fpn=True, input_size=(600, 600))
    want = ja.make_fpn_anchors(JConfig(**kw))
    got = ta.make_fpn_anchors(Config(**kw))
    assert got.shape == (90090, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ta.make_anchors(Config()),
                                  ja.make_anchors(JConfig()))
    assert (ta.fpn_feat_sizes((600, 600), 2, 6)
            == ja.fpn_feat_sizes((600, 600), 2, 6))


# ----------------------------------------------------------------- nms
def _tied_scores(rng, *shape):
    """Scores on a coarse grid, so many ties."""
    return (rng.randint(0, 20, size=shape) / 20.0).astype(np.float32)


@pytest.mark.parametrize("thr", [0.1, 0.5, 0.7])
def test_nms_matches_jax(rng, thr):
    """Batched nms / nms_padded == per-image JAX nms: exact indices, valid
    masks and scores; boxes <= 1e-6."""
    b, n, k = 3, 40, 12
    boxes = _boxes(rng, b, n, size=40.0)
    scores = _tied_scores(rng, b, n)
    valid = rng.rand(b, n) > 0.2
    idx, keep = tn.nms(T(boxes), T(scores), thr, k, valid=T(valid))
    pb, ps, pv = tn.nms_padded(T(boxes), T(scores), thr, k, valid=T(valid))
    for i in range(b):
        jidx, jkeep = jn.nms(boxes[i], scores[i], thr, k, valid=valid[i])
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        jb, js, jv = jn.nms_padded(boxes[i], scores[i], thr, k, valid=valid[i])
        np.testing.assert_allclose(pb[i].numpy(), np.asarray(jb), atol=1e-6)
        np.testing.assert_array_equal(ps[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(pv[i].numpy(), np.asarray(jv))


# ---------------------------------------------- kernel 1: greedy NMS rows
def _sorted_nms_inputs(rng, b=2, k=256, n_masked=20):
    """Score-sorted rows (stable, ties by lower index) with score ties,
    near-threshold (IoU ~ 0.7) pairs and masked (-1e9) tail rows."""
    boxes = _boxes(rng, b, k, size=120.0)
    # every 4th box gets a partner shifted so that IoU = (w-d)/(w+d) ~ 0.7
    w = boxes[:, 0:k:4, 2] - boxes[:, 0:k:4, 0]
    d = w * (0.3 / 1.7) * (1.0 + rng.uniform(-1e-6, 1e-6, w.shape))
    partner = boxes[:, 0:k:4].copy()
    partner[..., 0] += d
    partner[..., 2] += d
    boxes[:, 1:k:4] = partner
    scores = _tied_scores(rng, b, k)
    scores[:, k - n_masked:] = -1e9
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


def test_greedy_nms_rows_matches_pallas_kernel(rng):
    """Kernel 1's plain version == the interpreted Pallas
    ``_batched_nms_kernel``: exact valid mask and scores, boxes <= 1e-6."""
    boxes, scores = _sorted_nms_inputs(rng)
    jb, js, jv = _truncated_nms_call(jnp.asarray(boxes), jnp.asarray(scores),
                                     nms_iou=0.7, n_post_nms=32, interpret=True)
    tb, ts, tv, _ = greedy_nms_rows_reference(T(boxes), T(scores),
                                              n_post=32, iou_threshold=0.7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    assert tv.numpy().sum(1).min() > 0


def test_greedy_nms_wrapper_uses_plain_version_on_cpu(rng):
    """On CPU tensors the wrapper runs the plain version, launches nothing."""
    boxes, scores = _sorted_nms_inputs(rng, b=1, k=64)
    before = counters["launch.greedy_nms"]
    got = greedy_nms(T(boxes), T(scores), n_post=8, iou_threshold=0.7)
    want = greedy_nms_rows_reference(T(boxes), T(scores), n_post=8,
                                     iou_threshold=0.7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counters["launch.greedy_nms"] == before


@pytest.mark.parametrize("n_pre", [64, 400])
def test_proposals_batched_matches_create_proposals(rng, n_pre):
    """Whole plain proposal path == JAX ``create_proposals`` vmapped, on the
    truncated route (6 * 64 <= 1023 anchors) and the whole-table route
    (6 * 400 > 1023), and so does the port's batched ``create_proposals``:
    equal valid, boxes/scores <= 1e-4."""
    cfg = JConfig(fpn=True, input_size=(64, 64))
    anchors = ja.make_fpn_anchors(cfg)
    n = anchors.shape[0]
    b = 2
    locs = (rng.randn(b, n, 4) * 0.3).astype(np.float32)
    fg = rng.rand(b, n).astype(np.float32)
    kw = dict(nms_iou=0.7, n_post_nms=16, min_size=4.0)
    jr_, js_, jv_ = jax.vmap(lambda l, s: j_create_proposals(
        l, s, jnp.asarray(anchors), (64, 64), n_pre_nms=n_pre, **kw))(locs, fg)
    tr_, ts_, tv_ = proposals_batched(T(locs), T(fg), T(anchors), (64, 64),
                                      n_pre_nms=n_pre, **kw)
    cr_, cs_, cv_ = t_create_proposals(T(locs), T(fg), T(anchors), (64, 64),
                                       n_pre_nms=n_pre, **kw)
    for r, s, v in ((tr_, ts_, tv_), (cr_, cs_, cv_)):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv_))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr_), atol=1e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(js_), atol=1e-4)


# --------------------------------------- kernel 2: windowed RoIAlign
LEVELS_HW = [(40, 40), (20, 20), (10, 10), (5, 5)]
SCALES = tuple((h / 160.0, w / 160.0) for h, w in LEVELS_HW)


def _align_data(rng, b=2, r=24, c=16, levels_hw=LEVELS_HW, img=160.0,
                extreme=True):
    """Rois of mixed sizes; with ``extreme``, 8 per image of aspect 8-20
    that overflow their window (the edge-clamped case), and a few hanging
    over the image edge."""
    pyr = [rng.rand(b, h, w, c).astype(np.float32) for h, w in levels_hw]
    sides = rng.choice([img / 8, img / 3, img / 1.5], size=(b, r))
    ar = rng.uniform(0.5, 2.0, size=(b, r))
    if extreme:
        ar[:, :8] = rng.uniform(8.0, 20.0, size=(b, 8))
    x1 = rng.rand(b, r) * img * 0.7 - img * 0.05
    y1 = rng.rand(b, r) * img * 0.7 - img * 0.05
    rois = np.stack([x1, y1, x1 + sides * np.sqrt(ar), y1 + sides / np.sqrt(ar)],
                    -1).astype(np.float32)
    levels = np.array(jax.vmap(lambda q: j_level(q, 2, 5) - 2)(rois))
    return pyr, rois, levels


def test_multilevel_roi_align_matches_jax(rng):
    """Kernel 2's plain version == JAX ``multilevel_roi_align`` vmapped,
    edge-clamped rois included: <= 1e-5 (float32 summation order)."""
    pyr, rois, levels = _align_data(rng)
    want = jax.vmap(lambda pi, ri, li: jr.multilevel_roi_align(
        pi, ri, li, SCALES, 7, window=32))(tuple(pyr), rois, levels)
    got = windowed_roi_align_batched([T(p) for p in pyr], T(rois),
                                     T(levels.astype(np.int32)), SCALES, 7,
                                     window=32)
    assert got.shape == (2, 24, 7, 7, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    cov = tr.window_coverage(T(rois), T(levels), LEVELS_HW, SCALES)
    want_cov = jax.vmap(lambda ri, li: jr.window_coverage(
        ri, li, LEVELS_HW, SCALES))(rois, levels)
    np.testing.assert_array_equal(cov.numpy(), np.asarray(want_cov))
    assert not cov.all()       # the edge-clamped case is exercised


def test_windowed_prologue_matches_jax(rng):
    """Origins and window-relative weights equal the JAX prologue's
    (``x_quant=1``): origins exact, weights <= 1e-6."""
    pyr, rois, levels = _align_data(rng, b=1)
    f = [p[0] for p in pyr]
    _, jsy, jox, jwy, jwx = jr._windowed_prologue(f, rois[0], levels[0],
                                                  SCALES, 7, 2, 32, False)
    _, tsy, tox, twy, twx = tr._windowed_prologue(
        [T(p) for p in f], T(rois[0]), T(levels[0]), SCALES, 7, 2, 32, False)
    np.testing.assert_array_equal(tsy.numpy(), np.asarray(jsy))
    np.testing.assert_array_equal(tox.numpy(), np.asarray(jox))
    np.testing.assert_allclose(twy.numpy(), np.asarray(jwy), atol=1e-6)
    np.testing.assert_allclose(twx.numpy(), np.asarray(jwx), atol=1e-6)


def test_windowed_align_matches_pallas_kernel_on_covered_rois(rng):
    """Kernel 2's plain version == the interpreted Pallas ``_kernel`` at
    C=128 on a 64x64 image, on the rois the window covers (there both are
    exact RoIAlign; elsewhere the Pallas kernel's 8-aligned x origin clamps
    differently): <= 1e-5."""
    hw = [(16, 16), (8, 8), (4, 4), (2, 2)]
    scales = tuple((h / 64.0, w / 64.0) for h, w in hw)
    pyr, rois, levels = _align_data(rng, b=2, r=12, c=128, levels_hw=hw,
                                    img=64.0, extreme=False)
    want = np.asarray(j_windowed([jnp.asarray(p) for p in pyr],
                                 jnp.asarray(rois), jnp.asarray(levels),
                                 scales, 7, window=32, interpret=True))
    got = windowed_roi_align_batched([T(p) for p in pyr], T(rois),
                                     T(levels.astype(np.int32)), scales, 7,
                                     window=32).numpy()
    cov = tr.window_coverage(T(rois), T(levels), hw, scales).numpy()
    assert cov.sum() >= 12
    np.testing.assert_allclose(got[cov], want[cov], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the public
# functions without a place on a model's path
@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_matches_jax(rng, aligned):
    """The single-level RoIAlign within 1e-5 of the JAX one (by gathers):
    rois inside the map, hanging off it (clipped samples) and thinner than
    a pixel (``max(side, 1)``), at stride 4, ``aligned`` both ways."""
    f = rng.randn(2, 17, 23, 8).astype(np.float32)
    rois = _boxes(rng, 2, 10, size=80.0)
    rois[:, 0] = [-20.0, -12.0, 30.0, 40.0]          # off the top-left
    rois[:, 1] = [70.0, 50.0, 130.0, 90.0]           # off the right edge
    rois[:, 2] = [10.0, 10.0, 11.0, 60.0]            # a sliver
    want = np.stack([np.asarray(jr.roi_align(
        jnp.asarray(f[i]), jnp.asarray(rois[i]), 7, 0.25, 2, aligned))
        for i in range(2)])
    got = tr.roi_align(T(f), T(rois), 7, 0.25, 2, aligned).numpy()
    assert got.shape == (2, 10, 7, 7, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_nms_keep_mask_sorted_matches_jax(rng, thr):
    """The tiled keep-mask sweep equal to the JAX mask, padding rows (which
    come back True) included: 50 boxes in clusters (every tile suppresses
    within itself and across earlier tiles) and 14 zero rows, tiles of 16."""
    centres = rng.rand(6, 2) * 80.0
    xy = centres[rng.randint(0, 6, 50)] + rng.randn(50, 2) * 4.0
    wh = 20.0 + rng.rand(50, 2) * 10.0
    boxes = np.zeros((64, 4), np.float32)
    boxes[:50] = np.concatenate([xy, xy + wh], -1)
    want = np.asarray(jn.nms_keep_mask_sorted(jnp.asarray(boxes), thr,
                                              tile_size=16))
    got = tn.nms_keep_mask_sorted(T(boxes), thr, tile_size=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[50:].all() and 0 < got[:50].sum() < 50


@pytest.mark.parametrize("data", ["random", "ties"])
def test_roi_pool_structured_matches_jax(rng, data):
    """``roi_pool_structured``'s forward equal to the JAX one and its
    gradient within 1e-6, on a random map and on a map of coarse values,
    half of them exact zeros (ties share the cotangent)."""
    h, w, c, scale = 13, 11, 8, 1.0 / 16
    if data == "ties":
        f = np.maximum(rng.randint(-4, 4, size=(2, h, w, c)), 0) / 2.0
    else:
        f = rng.randn(2, h, w, c)
    xy = rng.rand(2, 6, 2) * np.array([w, h]) * 16 * 0.6
    rois = np.concatenate([xy, xy + rng.rand(2, 6, 2) * 100 + 20], -1)
    rois[:, 0] = [-90.0, -80.0, 30.0, 40.0]          # empty bins
    f, rois = f.astype(np.float32), rois.astype(np.float32)
    g = rng.randn(2, 6, 7, 7, c).astype(np.float32)

    def j_loss(fi, ri, gi):
        return jnp.sum(jr.roi_pool_structured(fi, ri, 7, scale) * gi)

    want = [jax.value_and_grad(lambda fi: j_loss(fi, rois[i], g[i]))(
        jnp.asarray(f[i])) for i in range(2)]
    want_out = np.stack([np.asarray(jr.roi_pool_structured(
        jnp.asarray(f[i]), jnp.asarray(rois[i]), 7, scale)) for i in range(2)])
    ft = T(f).requires_grad_(True)
    out = tr.roi_pool_structured(ft, T(rois), 7, scale)
    (out * T(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    np.testing.assert_allclose(ft.grad.numpy(),
                               np.stack([np.asarray(d) for _, d in want]),
                               rtol=1e-6, atol=1e-6)
