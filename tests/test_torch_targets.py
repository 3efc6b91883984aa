"""PyTorch port, training targets and losses (``nets/targets.py``,
``nets/losses.py``) against the JAX package, float32 on the CPU.

The same seeded numpy inputs go through the JAX function (one image at a
time under ``jax.vmap``, as the JAX detector calls it) and through the
port's batched counterpart, with deterministic sampling on both sides
(``key=None`` / ``generator=None``): labels, indices and masks must be
equal, locs within 1e-6.  The random samplers draw from different streams,
so only their counts are checked.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.nets import losses as jlosses
from two_stage_object_detection_tpu.nets import targets as jtargets
from two_stage_object_detection_tpu_torch.nets import losses, targets

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_anchors(step=8, size=96, sides=(16, 32)):
    c = np.arange(step / 2, size, step)
    cy, cx = np.meshgrid(c, c, indexing="ij")
    out = [np.stack([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2], -1)
           for s in sides]
    return np.stack(out, 2).reshape(-1, 4).astype(np.float32)


def _gt(rng, b=3, g=6, size=96):
    xy = rng.rand(b, g, 2) * (size - 40)
    boxes = np.concatenate([xy, xy + rng.rand(b, g, 2) * 32 + 8], -1)
    valid = np.arange(g)[None] < rng.randint(1, g + 1, size=(b, 1))
    boxes[~valid] = 0.0
    return (boxes.astype(np.float32), valid,
            rng.randint(0, 5, size=(b, g)).astype(np.int32))


def _case(name, rng):
    """``(gt_boxes, gt_valid, gt_labels, kwargs)`` of a named case."""
    boxes, valid, labels = _gt(rng)
    kw = {}
    if name == "no_valid_gt":
        valid[1] = False                  # one image without any gt
        boxes[1] = 0.0
    elif name == "shared_best_anchor":
        # gts 0 and 1 of image 0 sit on one anchor (1 px apart): both take
        # it as their best, and the later one must win it
        boxes[0, 0] = [20, 20, 36, 36]
        boxes[0, 1] = [21, 20, 37, 36]
        valid[0, :2] = True
    elif name == "over_the_cap":
        kw = dict(n_sample=8)             # 4 positives at most
        boxes[:, 0] = [8, 8, 72, 72]
        valid[:, 0] = True
    return boxes, valid, labels, kw


CASES = ["random", "no_valid_gt", "shared_best_anchor", "over_the_cap"]


@pytest.mark.parametrize("case", CASES)
def test_anchor_target_matches_jax(rng, case):
    """Labels equal, locs within 1e-6, with first-k sampling."""
    boxes, valid, _, kw = _case(case, rng)
    anchors = _grid_anchors()
    kw = {"n_sample": 32, "pos_iou_thresh": 0.6, **kw}
    if case == "over_the_cap":
        kw["pos_iou_thresh"] = 0.35       # many anchors over the threshold
    fn = functools.partial(jtargets.anchor_target, **kw)
    want_loc, want_label = jax.vmap(lambda b, v: fn(anchors, b, v))(boxes, valid)
    loc, label = targets.anchor_target(T(anchors), T(boxes), T(valid), **kw)
    np.testing.assert_array_equal(label.numpy(), np.asarray(want_label))
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), rtol=0,
                               atol=1e-6)
    want_label = np.asarray(want_label)
    if case == "no_valid_gt":
        assert (want_label[1] == -1).all() and (loc.numpy()[1] == 0).all()
    else:
        assert (want_label == 1).any() and (want_label == 0).any()
    if case == "over_the_cap":
        n_pos = (want_label == 1).sum(1)
        assert (n_pos <= 4).all() and (n_pos == 4).any()    # the cap engaged


def test_anchor_target_later_gt_wins_shared_anchor(rng):
    """The shared best anchor regresses to gt 1, not gt 0, in both packages
    (the port resolves the duplicate scatter with an amax of the gt index)."""
    boxes, valid, _, _ = _case("shared_best_anchor", rng)
    anchors = _grid_anchors()
    loc, label = targets.anchor_target(T(anchors), T(boxes), T(valid),
                                       n_sample=512)
    want_loc, _ = jtargets.anchor_target(anchors, boxes[0], valid[0],
                                         n_sample=512)
    from two_stage_object_detection_tpu_torch.ops.geometry import bbox2loc
    a = int(np.argmax((anchors == [20, 20, 36, 36]).all(1)))
    assert label[0, a] == 1
    to_gt1 = bbox2loc(T(anchors[a:a + 1]), T(boxes[0, 1:2]))[0]
    to_gt0 = bbox2loc(T(anchors[a:a + 1]), T(boxes[0, 0:1]))[0]
    assert torch.allclose(loc[0, a], to_gt1, atol=1e-6)
    assert not torch.allclose(loc[0, a], to_gt0, atol=1e-3)
    np.testing.assert_allclose(loc[0].numpy(), np.asarray(want_loc), atol=1e-6)


@pytest.mark.parametrize("loc_std", [None, (0.1, 0.1, 0.2, 0.2)])
@pytest.mark.parametrize("case", CASES)
def test_proposal_target_matches_jax(rng, case, loc_std):
    """Sampled rois, labels and validity equal, locs within 1e-6 (1e-5 when
    divided by the stds), with first-k sampling."""
    boxes, valid, labels, kw = _case(case, rng)
    b = boxes.shape[0]
    jit = rng.randn(b, 20, 4) * 6
    rois = np.clip(np.concatenate([np.repeat(boxes, 3, 1) + jit[:, :18],
                                   rng.rand(b, 14, 4) * 90], 1), 0, 96)
    rois = np.concatenate([np.minimum(rois[..., :2], rois[..., 2:]),
                           np.maximum(rois[..., :2], rois[..., 2:]) + 4], -1)
    rois = rois.astype(np.float32)
    roi_valid = rng.rand(b, 32) < 0.85
    kw = {"n_sample": 16, **kw, "loc_std": loc_std}
    fn = functools.partial(jtargets.proposal_target, **kw)
    want = jax.vmap(fn)(rois, roi_valid, boxes, valid, labels)
    got = targets.proposal_target(T(rois), T(roi_valid), T(boxes), T(valid),
                                  T(labels), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        if i == 1:
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 if loc_std else 1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    sample_valid = np.asarray(want[3])
    label = np.asarray(want[2])
    if case == "no_valid_gt":
        assert (label[1] == 0).all()      # zero positives in that image
    assert (label > 0).any() and sample_valid.any()
    if case == "over_the_cap":
        n_pos = (label > 0).sum(1)
        assert (n_pos <= 4).all() and (n_pos == 4).any()    # the cap engaged


def test_random_sampling_keeps_the_counts(rng):
    """With a generator the samplers pick other samples but the same number
    of positives and negatives as first-k sampling, and two draws differ."""
    boxes, valid, labels, _ = _case("over_the_cap", rng)
    anchors = _grid_anchors()
    first = targets.anchor_target(T(anchors), T(boxes), T(valid), n_sample=16,
                                  pos_iou_thresh=0.5)[1]
    g = torch.Generator().manual_seed(0)
    draws = [targets.anchor_target(T(anchors), T(boxes), T(valid), n_sample=16,
                                   pos_iou_thresh=0.5, generator=g)[1]
             for _ in range(2)]
    for d in draws:
        for v in (1, 0):
            assert torch.equal((d == v).sum(1), (first == v).sum(1))
    assert not torch.equal(draws[0], draws[1])
    want = jax.vmap(lambda b, v, k: jtargets.anchor_target(
        anchors, b, v, n_sample=16, pos_iou_thresh=0.5, key=k)[1])(
            boxes, valid, jax.random.split(jax.random.PRNGKey(0), 3))
    for v in (1, 0):
        np.testing.assert_array_equal((draws[0] == v).sum(1).numpy(),
                                      (np.asarray(want) == v).sum(1))
    rois = np.clip(np.repeat(boxes, 4, 1) + rng.randn(3, 24, 4) * 4, 0, 96
                   ).astype(np.float32)
    rv = np.ones((3, 24), bool)
    a = targets.proposal_target(T(rois), T(rv), T(boxes), T(valid), T(labels),
                                n_sample=12)
    r = targets.proposal_target(T(rois), T(rv), T(boxes), T(valid), T(labels),
                                n_sample=12, generator=g)
    assert torch.equal((a[2] > 0).sum(1), (r[2] > 0).sum(1))
    assert torch.equal(a[3].sum(1), r[3].sum(1))


@pytest.mark.parametrize("positives", ["some", "none"])
def test_loc_loss_matches_jax(rng, positives):
    """Smooth-L1 over positives: per image within 1e-6; zero positives give
    0, not NaN; the gradient matches too."""
    pred = rng.randn(3, 40, 4).astype(np.float32)
    gt = (pred + rng.randn(3, 40, 4) * 1.5).astype(np.float32)
    label = rng.randint(-1, 3, size=(3, 40)).astype(np.int32)
    if positives == "none":
        label = np.minimum(label, 0)
    want = jax.vmap(lambda p, g, l: jlosses.fast_rcnn_loc_loss(p, g, l, 1.0))(
        pred, gt, label)
    p = T(pred).requires_grad_(True)
    got = losses.fast_rcnn_loc_loss(p, T(gt), T(label), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    assert np.isfinite(got.detach().numpy()).all()
    if positives == "none":
        assert (got == 0).all()
    want_g = jax.grad(lambda p: jnp.mean(jax.vmap(
        lambda p, g, l: jlosses.fast_rcnn_loc_loss(p, g, l, 1.0))(
            p, gt, label)))(pred)
    got.mean().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), atol=1e-6)
    # unbatched: the JAX scalar
    one = losses.fast_rcnn_loc_loss(T(pred[0]), T(gt[0]), T(label[0]), 3.0)
    np.testing.assert_allclose(one.numpy(), np.asarray(
        jlosses.fast_rcnn_loc_loss(pred[0], gt[0], label[0], 3.0)), atol=1e-6)


@pytest.mark.parametrize("labelled", ["some", "none"])
def test_cross_entropy_with_ignore_matches_jax(rng, labelled):
    """Mean CE over labels != -1: per image within 1e-6, all-ignored rows
    give 0, and the gradient matches."""
    logits = (rng.randn(3, 30, 5) * 3).astype(np.float32)
    label = rng.randint(-1, 5, size=(3, 30)).astype(np.int32)
    if labelled == "none":
        label[:] = -1
    want = jax.vmap(jlosses.softmax_cross_entropy_with_ignore)(logits, label)
    x = T(logits).requires_grad_(True)
    got = losses.softmax_cross_entropy_with_ignore(x, T(label))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    want_g = jax.grad(lambda x: jnp.mean(jax.vmap(
        jlosses.softmax_cross_entropy_with_ignore)(x, label)))(logits)
    got.mean().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6)
    if labelled == "none":
        assert (got == 0).all()
