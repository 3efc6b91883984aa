"""PyTorch port, Mask R-CNN on the CPU: the mask branch (``nets/fpn.py:
FPNMaskHead``, ``FasterRCNN.mask_predict`` and the mask loss), its targets,
``paste_masks``, the served ``masks`` field and the polygon data path,
against the benchmark's plain reference (``port_bench/reference/
mask_rcnn.py``) on seeded weights: ResNet-10 FPN, a 96x128 input, 3
classes, 5 detections an image.

Both sides run float32 on the CPU with the same plain operations (the
port's kernel routes are switched off there), so most comparisons hold to
a few float32 roundings of each tensor's largest magnitude (1e-5 of it):
the port feeds its convolutions channels-last views of the pooled rows and
sums the rasterised crossings per row, the reference in its own order.
Rasterised targets are compared exactly: the same comparisons of the same
float32 numbers.  Kernel 2 at P=14 on the card is held in
``tests/test_torch_kernels.py``.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from port_bench import counts_mask, harness  # noqa: E402
from port_bench.reference import config as ref_config  # noqa: E402
from port_bench.reference import mask_rcnn as ref_mask  # noqa: E402
from port_bench.reference.layers import init_weights as ref_init  # noqa: E402
from port_bench.runner import Run  # noqa: E402
from tests.bench_ticks import ticking_driver  # noqa: E402
from two_stage_object_detection_tpu_torch.config import Config  # noqa: E402
from two_stage_object_detection_tpu_torch.data import (  # noqa: E402
    coco, device_transforms, synthetic, transforms)
from two_stage_object_detection_tpu_torch.data.pipeline import (  # noqa: E402
    DetectionDataset)
from two_stage_object_detection_tpu_torch.nets.detector import (  # noqa: E402
    FasterRCNN)
from two_stage_object_detection_tpu_torch.nets.losses import (  # noqa: E402
    mask_loss)
from two_stage_object_detection_tpu_torch.nets.targets import (  # noqa: E402
    mask_targets)
from two_stage_object_detection_tpu_torch.nets.trainer import (  # noqa: E402
    create_train_state, train_step)
from two_stage_object_detection_tpu_torch.serving import (  # noqa: E402
    Predictor, paste_masks)

KW = dict(fpn=True, backbone="resnet10", input_size=(96, 128), num_classes=3,
          max_detections=5, compute_dtype="float32", n_train_pre_nms=256,
          n_train_post_nms=64, n_test_pre_nms=128, n_test_post_nms=32,
          roi_n_sample=16, rpn_n_sample=32, max_gt_boxes=4, loc_normalize=True,
          grad_accum_steps=1, mask_head=True, max_mask_vertices=16)
MASK_KW = dict(mask_roi_size=14, mask_dim=256, mask_convs=4)
IMG = (96, 128)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_config():
    names = {f.name for f in ref_config.dataclasses.fields(ref_config.Config)}
    return ref_config.Config(**{k: v for k, v in KW.items() if k in names})


def build(seed: int = 7):
    """``(port, reference)``: the reference's seeded weights (the box
    detector from ``seed``, the mask head from ``seed + 1``, its predictor
    scaled by 4 so that masks span (0, 1)) loaded into the port."""
    ref = ref_mask.MaskRCNN(_ref_config(), **MASK_KW)
    ref_init(ref, seed)
    ref_mask.init_mask_head(ref.mask_head, seed + 1)
    with torch.no_grad():
        ref.mask_head.predictor.weight.mul_(4.0)
    port = FasterRCNN(Config(**KW, device="cpu"))
    port.load_state_dict(ref.state_dict())
    return port, ref


@pytest.fixture(scope="module")
def models():
    return build()


@pytest.fixture(scope="module")
def images():
    return torch.rand(2, *IMG, 3, generator=torch.Generator().manual_seed(3))


def _rois(rng, b, r, lo=2.0, hi=70.0):
    x1 = rng.rand(b, r, 1) * 100
    y1 = rng.rand(b, r, 1) * 70
    wh = rng.rand(b, r, 2) * (hi - lo) + lo
    return torch.from_numpy(np.concatenate(
        [x1, y1, x1 + wh[..., :1], y1 + wh[..., 1:]], -1).astype(np.float32))


def _close(got, want, rel=1e-5):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("window,use_window", [(32, True), (32, False),
                                               (0, True)])
def test_mask_head_logits_match_reference(models, images, window, use_window):
    """The windowed route (predict), the hybrid route's forward (training)
    and the dense route (``fpn_roi_window=0``): the logits of each roi's
    class, 1e-5 of their largest magnitude."""
    port, ref = models
    rng = np.random.RandomState(0)
    rois, labels = _rois(rng, 2, 6), torch.from_numpy(rng.randint(0, 4, (2, 6)))
    with torch.no_grad():
        feats = ref.features(images)
        heads = (port.mask_head, ref.mask_head)
        for h in heads:
            h.window = window
        try:
            got = port.mask_head(feats, rois, labels, IMG, use_window=use_window)
            want = ref.mask_head(feats, rois, labels, IMG, use_window=use_window)
        finally:
            for h in heads:
                h.window = 32
    assert got.shape == (2, 6, 28, 28) and got.dtype == torch.float32
    _close(got, want)


def test_mask_predict_on_given_boxes(models, images):
    """``mask_predict``: the sigmoid of each given detection's class channel,
    zero where ``valid`` is False, as the reference's."""
    port, ref = models
    rng = np.random.RandomState(1)
    boxes = _rois(rng, 2, 5)
    labels = torch.from_numpy(rng.randint(1, 4, (2, 5)))
    valid = torch.tensor([[True, True, False, True, False],
                          [False, True, True, True, True]])
    with torch.no_grad():
        got = port.mask_predict(port.features(images), boxes, labels, valid,
                                IMG)
        want = ref.mask_predict(ref.features(images), boxes, labels, valid,
                                IMG)
    assert got.shape == (2, 5, 28, 28)
    assert bool((got[~valid] == 0).all())
    assert 0.05 < float(got[valid].std())          # masks span (0, 1)
    _close(got, want)


def test_predict_returns_five_outputs(models, images):
    """``predict``: the reference's boxes, scores, labels and valid slots,
    then each kept detection's mask."""
    port, ref = models
    got = port.predict(images)
    want = ref.predict(images)
    assert len(got) == 5 and got[4].shape == (2, 5, 28, 28)
    assert bool(got[3].any())
    for i in (2, 3):
        assert torch.equal(got[i], want[i])
    for i in (0, 1, 4):
        _close(got[i], want[i])


def _square(x1, y1, x2, y2):
    return np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)


def _packed(objects, v=16):
    """``(polys [1, G, v, 2], edges [1, G, v])`` of ``objects``, each a list
    of rings."""
    packed = [coco.pack_polygon(rings, v) for rings in objects]
    return (torch.from_numpy(np.stack([p for p, _ in packed])[None]),
            torch.from_numpy(np.stack([e for _, e in packed])[None]))


def _bin_centres(lo, hi, m=28):
    return lo + (np.arange(m) + 0.5) * (hi - lo) / m


@pytest.mark.parametrize("case", ["two_rings", "partly_outside", "flipped"])
def test_mask_targets_match_reference(case):
    """The rasterised targets equal the reference's bit for bit, and the
    even-odd rule's answer: a ring inside another is a hole; a roi that
    reaches past its polygon is 0 there; a flipped image's polygon and roi
    (``device_transforms``' flip) give the mirrored mask."""
    rng = np.random.RandomState(2)
    outer, hole = _square(10, 10, 50, 50), _square(20, 20, 40, 40)
    if case == "two_rings":
        polys, edges = _packed([[outer, hole]])
        rois = torch.tensor([[[0.0, 0.0, 60.0, 60.0]]])
        c = _bin_centres(0.0, 60.0)
        inside = (c > 10) & (c < 50)
        in_hole = (c > 20) & (c < 40)
        want = ((inside[:, None] & inside[None, :])
                & ~(in_hole[:, None] & in_hole[None, :]))
    elif case == "partly_outside":
        polys, edges = _packed([[outer]])
        rois = torch.tensor([[[30.0, 22.0, 90.0, 61.0]]])
        cx, cy = _bin_centres(30.0, 90.0), _bin_centres(22.0, 61.0)
        want = ((cy > 10) & (cy < 50))[:, None] & ((cx > 10) & (cx < 50))[None]
    else:
        ang = np.sort(rng.rand(9)) * 2 * np.pi
        ring = np.stack([60 + 25 * np.cos(ang) * (0.6 + 0.4 * rng.rand(9)),
                         40 + 20 * np.sin(ang) * (0.6 + 0.4 * rng.rand(9))],
                        -1).astype(np.float32)
        polys, edges = _packed([[ring], [outer]])
        rois = torch.tensor([[[33.0, 17.0, 88.0, 63.0], [5.0, 8.0, 47.0, 44.0]]])
        flip = torch.tensor([True])
        fpolys = device_transforms._hflip_polys(polys, flip, IMG[1])
        w = IMG[1]
        frois = torch.stack([w - rois[..., 2], rois[..., 1], w - rois[..., 0],
                             rois[..., 3]], -1)
        index = torch.tensor([[0, 1]])
        plain = mask_targets(polys, edges, index, rois, 28)
        got = mask_targets(fpolys, edges, index, frois, 28)
        assert torch.equal(got, ref_mask.rasterize(fpolys, edges, index,
                                                   frois, 28))
        agree = (got == torch.flip(plain, dims=(-1,))).float().mean()
        assert float(agree) >= 0.99 and float(plain.sum()) > 50
        return
    index = torch.zeros((1, 1), dtype=torch.int64)
    got = mask_targets(polys, edges, index, rois, 28)
    assert torch.equal(got, ref_mask.rasterize(polys, edges, index, rois, 28))
    assert torch.equal(got[0, 0].bool(), torch.from_numpy(want))


def test_mask_loss_and_gradients_match_reference(models, images):
    """The mask loss on the hybrid route (kernel 2's forward, the dense
    RoIAlign's gradient) and its gradients with respect to every mask-head
    parameter and every pyramid level, against the reference's, 1e-5 of each
    tensor's largest magnitude."""
    port, ref = models
    rng = np.random.RandomState(4)
    rois = _rois(rng, 2, 6, lo=8.0)
    labels = torch.from_numpy(rng.randint(0, 4, (2, 6)))
    valid = labels > 0
    polys = torch.from_numpy(
        (rois.numpy()[:, :, None, :2] + rng.rand(2, 6, 16, 2) * 30)
        .astype(np.float32))
    edges = torch.from_numpy(rng.rand(2, 6, 16) < 0.9)
    index = torch.from_numpy(rng.randint(0, 6, (2, 6)))
    target = mask_targets(polys, edges, index, rois, 28)
    with torch.no_grad():
        base = ref.features(images)
    grads = []
    for model, loss_fn in ((port, mask_loss), (ref, ref_mask.mask_bce)):
        feats = [f.clone().requires_grad_(True) for f in base]
        model.mask_head.zero_grad()
        logits = model.mask_head(feats, rois, labels, IMG, use_window=False)
        loss = loss_fn(logits, target, valid)
        loss.backward()
        grads.append((loss.detach(), [f.grad for f in feats[:4]],
                      {n: p.grad.clone()
                       for n, p in model.mask_head.named_parameters()}))
    (lp, fp, pp), (lr, fr, pr) = grads
    assert abs(float(lp - lr)) <= 1e-6 * float(lr) and float(lr) > 0.1
    for g, w in zip(fp, fr):
        _close(g, w)
    assert pp.keys() == pr.keys()
    for n in pp:
        _close(pp[n], pr[n])


def test_train_forward_adds_the_mask_loss(images):
    """A whole ``train_forward`` with ``gt_polys`` (BN in train mode, first-k
    sampling): the port's five losses equal the reference's, the mask loss
    is in the total, and the mask head's gradients agree."""
    port, ref = build(11)
    gt = torch.tensor([[[10.0, 12.0, 60.0, 70.0], [70.0, 20.0, 120.0, 60.0],
                        [0, 0, 0, 0], [0, 0, 0, 0]],
                       [[30.0, 30.0, 90.0, 80.0], [5.0, 5.0, 40.0, 45.0],
                        [50.0, 10.0, 110.0, 50.0], [0, 0, 0, 0]]])
    gv = torch.tensor([[True, True, False, False], [True, True, True, False]])
    gl = torch.tensor([[0, 2, 0, 0], [1, 1, 2, 0]])
    objects = []
    for b in range(2):
        for g in range(4):
            x1, y1, x2, y2 = gt[b, g].tolist()
            objects.append([_square(x1 + 3, y1 + 2, x2 - 4, y2 - 1)]
                           if gv[b, g] and (b, g) != (1, 2) else [])
    polys, edges = _packed(objects)
    polys, edges = polys.reshape(2, 4, 16, 2), edges.reshape(2, 4, 16)
    outs = []
    for model in (port, ref):
        model.zero_grad()
        o = model.train_forward(images, gt, gl, gv, gt_polys=polys,
                                gt_poly_edges=edges)
        o["losses"]["total"].backward()
        outs.append(({k: v.detach() for k, v in o["losses"].items()},
                     {n: p.grad.clone() for n, p in
                      model.mask_head.named_parameters()}))
    (lp, gp), (lr, gr) = outs
    assert set(lp) == set(lr) == {"rpn_loc", "rpn_cls", "roi_loc", "roi_cls",
                                  "mask", "total"}
    for k in lp:
        assert abs(float(lp[k] - lr[k])) <= 1e-5 * max(float(lr[k]), 1.0), k
    assert float(lp["mask"]) > 0.1
    for n in gp:
        _close(gp[n], gr[n])


def test_paste_masks_matches_reference():
    """``paste_masks``: each mask read bilinearly at the pixel centres of
    its box (``grid_sample``) as the reference's explicit four taps; an
    all-ones mask fills its box and nothing beyond it."""
    rng = np.random.RandomState(6)
    boxes = _rois(rng, 2, 4, lo=5.0)
    masks = torch.from_numpy(rng.rand(2, 4, 28, 28).astype(np.float32))
    got = paste_masks(boxes, masks, IMG)
    want = ref_mask.paste_masks(boxes, masks, IMG)
    assert got.shape == (2, 4, *IMG) and got.dtype == torch.bool
    # a pixel whose value lies within rounding of 0.5 may fall either way
    assert float((got == want).float().mean()) >= 0.9999
    ones = paste_masks(torch.tensor([[10.0, 20.0, 40.0, 60.0]]),
                       torch.ones(1, 28, 28), IMG)[0]
    assert bool(ones[21:59, 11:39].all())
    assert not bool(ones[:19].any()) and not bool(ones[:, 41:].any())


def test_predictor_serves_masks_on_the_u8_wire(models):
    """``Predictor(wire="u8")``: a fifth field ``masks``, float16, each
    image's masks as ``predict`` gives them for its bucket."""
    port, _ = models
    x = np.random.RandomState(7).randint(0, 256, (3, *IMG, 3)).astype(np.uint8)
    pred = Predictor(Config(**KW, device="cpu"), port, batch_sizes=(1, 2),
                     wire="u8")
    out = pred(x)
    assert list(out) == ["boxes", "scores", "labels", "valid", "masks"]
    assert out["masks"].shape == (3, 5, 28, 28)
    assert out["masks"].dtype == np.float16
    f = torch.from_numpy(x).float() / 255.0
    want = torch.cat([port.predict(f[:2])[4], port.predict(f[2:])[4]])
    np.testing.assert_allclose(out["masks"].astype(np.float32),
                               want.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out["masks"][~out["valid"]], 0)


@pytest.mark.parametrize("route", ["fpn_off", "spatial", "int8",
                                   "tensor_parallel"])
def test_mask_head_refuses_other_routes(models, route):
    """``mask_head=True`` raises a ``ValueError`` naming the mask head on
    the single-scale model, ``Predictor(spatial=True)``, the int8 route and
    the tensor-parallel split."""
    port, _ = models
    cfg = Config(**KW, device="cpu")
    with pytest.raises(ValueError, match="mask_head"):
        if route == "fpn_off":
            FasterRCNN(cfg.replace(fpn=False))
        elif route == "spatial":
            Predictor(cfg, port, spatial=True)
        elif route == "int8":
            Predictor(cfg, port, int8_scales={"extractor.conv1": 1.0})
        else:
            from two_stage_object_detection_tpu_torch.parallel.sharding import (
                shard_train_state)
            _, state = create_train_state(cfg, device="cpu")
            shard_train_state(state, None)


def _coco_file(tmp_path):
    """A small COCO-layout file with polygons: two images, one object of
    two rings (one too short to keep), an RLE object, a crowd polygon, and
    one ring of 12 vertices (resampled to fit 8 slots)."""
    from PIL import Image
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for name in ("a.png", "b.png"):
        Image.new("RGB", (128, 96), (200, 200, 200)).save(img_dir / name)
    ring12 = [v for k in range(12)
              for v in (64 + 20 * np.cos(k * np.pi / 6),
                        48 + 20 * np.sin(k * np.pi / 6))]
    ann = {"images": [{"id": 1, "file_name": "a.png", "height": 96,
                       "width": 128},
                      {"id": 2, "file_name": "b.png", "height": 96,
                       "width": 128}],
           "categories": [{"id": 5, "name": "x"}, {"id": 9, "name": "y"}],
           "annotations": [
               {"id": 1, "image_id": 1, "category_id": 5,
                "bbox": [10, 10, 40, 30], "iscrowd": 0,
                "segmentation": [[10, 10, 50, 10, 50, 40, 10, 40],
                                 [20, 20, 30, 20]]},
               {"id": 2, "image_id": 1, "category_id": 9,
                "bbox": [60, 50, 20, 20], "iscrowd": 0,
                "segmentation": {"counts": [0, 4], "size": [96, 128]}},
               {"id": 3, "image_id": 2, "category_id": 9,
                "bbox": [5, 5, 30, 30], "iscrowd": 1,
                "segmentation": [[5, 5, 35, 5, 35, 35]]},
               {"id": 4, "image_id": 2, "category_id": 5,
                "bbox": [44, 28, 40, 40], "iscrowd": 0,
                "segmentation": [ring12]}]}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(ann))
    return str(path), str(img_dir)


def test_coco_polygons_reach_the_batch(tmp_path):
    """``load_coco(polygons=True)`` keeps each object's rings of 3 or more
    vertices, none for RLE or crowd objects; ``DetectionDataset`` packs them
    into the boxes' slots (a ring too long resampled, each ring closed by
    its first vertex), scaled and flipped as the boxes are."""
    path, img_dir = _coco_file(tmp_path)
    idx = coco.load_coco(path, img_dir, seed=None, polygons=True)
    plain = coco.load_coco(path, img_dir, seed=None)
    assert "polys" not in plain.records[0]
    by_id = {r["image_id"]: r for r in idx.records}
    a, b = by_id[1], by_id[2]
    assert [len(p) for p in a["polys"]] == [1, 0]       # the 2-vertex ring dropped
    np.testing.assert_array_equal(a["polys"][0][0], _square(10, 10, 50, 40))
    assert [len(p) for p in b["polys"]] == [0, 1] and a["size"] == (96, 128)
    for kw in (dict(decode_only=True), dict(train=False), dict(train=True)):
        ds = DetectionDataset(idx, (48, 64), max_gt=3, max_vertices=8, **kw)
        for epoch in range(4):
            s = ds.get(idx.records.index(b), epoch)
            assert s["polys"].shape == (3, 8, 2) and s["poly_edges"].shape == (3, 8)
            assert not s["poly_edges"][0].any()          # the crowd object
            e = s["poly_edges"][1]
            assert e.tolist() == [True] * 7 + [False]    # 12 -> 7, closed
            p = s["polys"][1]
            np.testing.assert_array_equal(p[7], p[0])
            # the circle (centre (64, 48), radius 20) at half the size, its
            # centre on the flip's axis: 7 of its 12 vertices
            np.testing.assert_allclose(
                np.hypot(p[:7, 0] - 32, p[:7, 1] - 24), 10.0, atol=1e-4)
            box = s["boxes"][1]
            assert (p[:7] >= box[:2] - 1e-4).all()
            assert (p[:7] <= box[2:] + 1e-4).all()


@pytest.mark.parametrize("chain", ["train", "eval"])
def test_transforms_move_rings_with_their_boxes(chain):
    """``train_transform``/``eval_transform(polys=)``: the image, boxes and
    labels are those of the call without rings; a ring drawn through its
    box's corners still has the box's bounds exactly, over seeds that flip
    and seeds that do not; the box that sanitize drops takes its rings."""
    rng = np.random.RandomState(0)
    img = rng.rand(48, 80, 3).astype(np.float32)
    boxes = np.array([[4.0, 6.0, 30.0, 40.0], [50.0, 2.0, 77.0, 20.0],
                      [10.0, 10.0, 10.2, 30.0]], np.float32)   # the last too thin
    labels = np.array([1, 2, 3], np.int32)

    def ring(b):
        x1, y1, x2, y2 = b
        return np.array([[x1, y1], [x2, y1], [(x1 + x2) / 2, y2], [x1, y2]],
                        np.float32)

    polys = [[ring(b)] for b in boxes[:2]] + [[ring(boxes[2]), ring(boxes[2])]]
    tf = transforms.train_transform if chain == "train" else (
        transforms.eval_transform)
    flips = set()
    for seed in range(8):
        want = tf(img, boxes, labels, np.random.RandomState(seed), size=(32, 48))
        got = tf(img, boxes, labels, np.random.RandomState(seed), size=(32, 48),
                 polys=polys)
        assert len(got) == 4
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        out_boxes, out_labels, out_polys = got[1], got[2], got[3]
        assert out_labels.tolist() == [1, 2] and len(out_polys) == 2
        for box, (r,) in zip(out_boxes, out_polys):
            lo, hi = r.min(0), r.max(0)
            np.testing.assert_array_equal(np.concatenate([lo, hi]), box)
        # the first ring's first vertex is the box's top-left unflipped
        flips.add(bool(out_polys[0][0][0, 0] == out_boxes[0, 2]))
    assert flips == ({False, True} if chain == "train" else {False})


def test_synthetic_polygons():
    """``generate_synthetic_coco(polygons=True)``: each object one ring of
    6-12 vertices, its bbox the ring's bounds, painted inside its
    rectangle."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        path, _ = synthetic.generate_synthetic_coco(
            root, num_images=3, image_size=(96, 128), polygons=True)
        with open(path) as f:
            anns = json.load(f)["annotations"]
    assert anns
    for a in anns:
        (ring,) = a["segmentation"]
        xs, ys = ring[0::2], ring[1::2]
        assert 6 <= len(xs) <= 12
        np.testing.assert_allclose(
            a["bbox"], [min(xs), min(ys), max(xs) - min(xs),
                        max(ys) - min(ys)], atol=1e-6)


def test_device_augment_flips_polygons():
    """The device flip moves each vertex to ``w - x`` where the image is
    flipped, as it moves the box corners; boxes and pixels are those of the
    call without polygons."""
    g = torch.Generator().manual_seed(0)
    images = torch.rand(4, 32, 40, 3, generator=g)
    boxes = torch.tensor([[[4.0, 5.0, 20.0, 25.0]]]).repeat(4, 1, 1)
    polys = torch.tensor([[[[4.0, 5.0], [20.0, 5.0], [12.0, 25.0]]]]
                         ).repeat(4, 1, 1, 1)
    draws = device_transforms.draw_augment(4, torch.Generator().manual_seed(1))
    img_a, box_a = device_transforms.apply_augment(images, boxes, draws)
    img_b, box_b, poly_b = device_transforms.apply_augment(images, boxes,
                                                           draws, polys=polys)
    assert torch.equal(img_a, img_b) and torch.equal(box_a, box_b)
    flip = draws["flip"]
    assert bool(flip.any()) and bool((~flip).any())
    want = torch.where(flip[:, None, None, None],
                       torch.stack([40 - polys[..., 0], polys[..., 1]], -1),
                       polys)
    assert torch.equal(poly_b, want)
    assert torch.equal(box_b[..., 0], torch.where(flip[:, None],
                                                  40 - boxes[..., 2],
                                                  boxes[..., 0]))


def test_train_step_trains_the_mask_head_on_synthetic_polygons(tmp_path):
    """``train_step`` on batches of the polygon data path with the device
    augmentation: a finite mask loss in the total, and an update moves the
    mask head."""
    path, img_dir = synthetic.generate_synthetic_coco(
        str(tmp_path), num_images=4, image_size=IMG, polygons=True)
    ds = DetectionDataset(coco.load_coco(path, img_dir, polygons=True), IMG,
                          max_gt=4, max_vertices=16, decode_only=True,
                          uint8_images=True)
    batch = {k: np.stack([ds[i][k] for i in range(2)]) for k in ds[0]}
    _, state = create_train_state(Config(**KW, device="cpu", lr=1e-3),
                                  device="cpu")
    before = state.model.mask_head.predictor.weight.detach().clone()
    gen = torch.Generator().manual_seed(0)
    _, losses = train_step(state, batch, gen, device_augment=True)
    assert set(losses) >= {"mask", "total"}
    assert bool(torch.isfinite(losses["mask"])) and float(losses["mask"]) > 0
    assert not torch.equal(before, state.model.mask_head.predictor.weight)


def test_mask_flops_at_the_published_widths():
    """``port_bench/counts_mask.py``: 1.06 GFLOP a roi (four 3x3
    convolutions at 14x14x256, the transposed convolution, the predictor to
    80 classes at 28x28)."""
    cfg = ref_config.Config(fpn=True, num_classes=80)
    per_roi = counts_mask.mask_head_flops(cfg, MASK_KW, 1)
    want = (4 * 2 * 14 * 14 * 256 * 256 * 9 + 2 * 28 * 28 * 256 * 256
            + 2 * 28 * 28 * 256 * 80)
    assert per_roi == want and abs(per_roi / 1e9 - 1.06) < 0.005


def test_benchmark_cell_runs_tiny_on_the_cpu():
    """The new cell's driver at a tiny size on the CPU: requests served,
    masks compared on the same boxes, ``correct``.  Both sides compute in
    float32 here, so ``mask_gap`` is the float16 wire's rounding alone: at
    most 2^-12 a bin, over a mean ``|p_ref - 0.5|`` near 0.25, under 2e-3.

    The driver's clock ticks (``tests/bench_ticks.py``): its 2-s window
    holds 6 requests on every run.  On the wall clock it held as many as
    the load of the other test workers allowed, and none raised "no
    request completed inside the window"."""
    cell = harness.Cell(ROOT, "mask_r50.serve.u8_bulk64_masks")
    cell.traffic = {**cell.traffic, "images_per_request": 4,
                    "pool_requests": 2, "check_images": 4,
                    "batch_sizes": [1, 2]}
    tiny = dict(input_size=(64, 96), num_classes=3, n_test_pre_nms=64,
                n_test_post_nms=16, max_detections=8, compute_dtype="float32",
                backbone="resnet10", fpn_channels=32, mask_dim=16,
                fpn_fc_dim=64)
    run = Run(ROOT, cell, 2 ** 33 + 7, 2.0, 0, time.time(), "cpu",
              overrides=tiny)
    res = ticking_driver(cell, run.seconds, 6).drive(run)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["checks"]) == {"miss_share", "mask_gap"}
    assert res["checks"]["mask_gap"]["value"] <= 2e-3
    assert res["metrics"]["serve_img_per_s"] > 0
