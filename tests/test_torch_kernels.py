"""PyTorch port, the CUDA kernels (1, 2, 3/4, 5, 5's scatter backward, 6,
the conv epilogue and HarDNet's depth-wise store) against their plain
PyTorch versions.

These need an NVIDIA GPU and ``nvcc`` (the kernels build from
``two_stage_object_detection_tpu_torch/csrc`` at first use); without a GPU
they skip.  Run them on the GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest sets up JAX, which that machine
need not have; this file imports nothing of JAX.)

``chip_smoke.py`` repeats these checks at the full shapes of the predict
and train paths.
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models import hardnet
from two_stage_object_detection_tpu_torch.models.layers import BatchNorm
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.ops.conv_epilogue import (
    conv_epilogue, conv_epilogue_reference)
from two_stage_object_detection_tpu_torch.ops.depthwise_store import (
    depthwise_store, depthwise_store_reference, out_size)
from two_stage_object_detection_tpu_torch.ops.anchors import make_fpn_anchors
from two_stage_object_detection_tpu_torch.ops.proposals import (
    MAX_KERNEL_ROWS, _decode_masked, fused_proposals, fused_proposals_batched,
    fused_proposals_op, fused_proposals_rows_reference, greedy_nms,
    greedy_nms_op, greedy_nms_rows_reference, nms_chunks, proposals_batched,
    sorted_rows_reference)
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_pool_argmax, roi_pool_grad_first_argmax, scatter_argmax_grad)
from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
    roi_pool_bwd_recompute, roi_pool_fast)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    roi_pool_argmax_op, roi_pool_bwd_plan, roi_pool_bwd_scatter, roi_pool_max,
    roi_pool_plan, roi_pool_values_op)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    windowed_align_op, windowed_roi_align_batched)
from two_stage_object_detection_tpu_torch.quantize import (
    conv_int32, conv_int32_reference)
from two_stage_object_detection_tpu_torch.utils.profiling import counters
# the module beside this file, by its own name: an installed package
# named ``tests`` would shadow the directory's
from torch_nms_cases import offset_candidates

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_rows(rng, b, k, edges=False):
    """Score-sorted rows, the last tenth masked.  With ``edges``, image 0
    has every row masked, image 1 only 5 valid rows (fewer survivors than
    any ``n_post`` here) and image 2 one box repeated with jitter, so that
    each valid row suppresses nearly all after it and the walk reaches the
    last tile."""
    xy = rng.rand(b, k, 2) * 200.0
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 80 + 4], -1)
    scores = rng.randint(0, 30, size=(b, k)) / 30.0
    scores[:, -k // 10:] = -1e9
    if edges:
        scores[0] = -1e9
        scores[1, 5:] = -1e9
        boxes[2] = [50.0, 60.0, 150.0, 140.0] + rng.rand(k, 4) * 2.0
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1).astype(np.float32)
    scores = np.take_along_axis(scores, order, 1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("b,k,n_post,edges", [
    (3, 1, 1, False), (3, 64, 8, False), (3, 130, 40, False),
    (3, 3000, 300, False), (16, 3000, 300, False), (3, 12000, 600, False),
    (2, 28000, 600, False), (2, 65472, 300, False),
    (1, MAX_KERNEL_ROWS, 100, False), (3, 3000, 300, True),
    (3, 12000, 600, True)])
def test_greedy_nms_kernel_bitwise_equals_plain(rng, dev, b, k, n_post, edges):
    """Kernel 1 == its plain version, bit for bit, at the predict and train
    shapes, at 65,472 rows (at least 5 blocks an image) and the row cap,
    B=16, and on masked, few-survivor and all-suppressing images."""
    boxes, scores = _sorted_rows(rng, b, k, edges)
    boxes, scores = boxes.to(dev), scores.to(dev)
    before = counters["launch.greedy_nms"]
    got = greedy_nms(boxes, scores, n_post=n_post, iou_threshold=0.7)
    want = greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                     iou_threshold=0.7)
    torch.cuda.synchronize()
    assert counters["launch.greedy_nms"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if edges:
        kept = got[2].sum(1).tolist()
        assert kept[0] == 0 and 0 < kept[1] <= 5 and 0 < kept[2] < n_post


def test_greedy_nms_kernel_rejects_bad_input(dev):
    boxes = torch.zeros((1, 8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        greedy_nms(boxes, torch.zeros((1, 8), device=dev), n_post=2,
                   iou_threshold=0.5)


def _crowded_rows(rng, b, k, n_dup):
    """Score-sorted rows whose ``n_dup`` best are 1 px jitters of 6 boxes
    (each kept one suppresses the rest), then distinct boxes; the last
    tenth masked."""
    xy = rng.rand(b, k, 2) * 560.0
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 60 + 4], -1)
    base = rng.rand(b, 6, 2) * 400.0
    pick = np.take_along_axis(base, rng.randint(0, 6, (b, n_dup))[..., None], 1)
    boxes[:, :n_dup] = np.concatenate([pick, pick + 100.0], -1) + rng.rand(b, n_dup, 4)
    scores = np.concatenate([0.5 + rng.rand(b, n_dup) * 0.5,
                             rng.rand(b, k - n_dup) * 0.5], 1)
    scores[:, -k // 10:] = -1e9
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1).astype(np.float32)
    scores = np.take_along_axis(scores, order, 1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("k", [MAX_KERNEL_ROWS + 1, 250000])
@pytest.mark.parametrize("case", ["first_chunk", "crossing"])
def test_greedy_nms_kernel_above_the_row_cap(rng, dev, k, case):
    """Kernel 1 above the rows one launch holds walks in chunks
    (``nms_chunks``: 2 launches at 112,129 rows, 3 at 250,000) and equals
    its plain version bit for bit, one counted launch: where ``n_post`` is
    filled inside the first chunk, and where the first chunk keeps only 6
    rows (near-duplicates) so that the kept set crosses into later chunks,
    whose rows are first cleared against the earlier chunks' boxes."""
    b, n_post = 2, 300
    if case == "crossing":
        boxes, scores = _crowded_rows(rng, b, k, n_dup=int(0.6 * k))
    else:
        boxes, scores = _sorted_rows(rng, b, k)
    boxes, scores = boxes.to(dev), scores.to(dev)
    chunks = nms_chunks(k)
    assert len(chunks) == (2 if k == MAX_KERNEL_ROWS + 1 else 3)
    before = counters["launch.greedy_nms"]
    got = greedy_nms(boxes, scores, n_post=n_post, iou_threshold=0.7)
    want = greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                     iou_threshold=0.7)
    torch.cuda.synchronize()
    assert counters["launch.greedy_nms"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows0 = chunks[0][1]
    first = greedy_nms_rows_reference(boxes[:, :rows0], scores[:, :rows0],
                                      n_post=n_post, iou_threshold=0.7)[2]
    if case == "crossing":
        assert bool((first.sum(1) <= 6).all())
    else:
        assert bool((first.sum(1) == n_post).all())
    assert bool((got[2].sum(1) == n_post).all())


def _offset_rows(rng, b, r, n_class, case, size=600):
    """:func:`torch_nms_cases.offset_candidates` as
    ``class_offset_nms`` hands them to kernel 1: each class's boxes shifted
    by ``label * (size + 2)``, the invalid rows' scores at -1e9."""
    boxes, scores, labels = offset_candidates(rng, b, r, n_class, case, size)
    boxes = boxes + labels.to(torch.float32)[..., None] * (size + 2.0)
    return boxes.contiguous(), torch.where(scores > 0, scores, -1e9)


@pytest.mark.parametrize("n_post", [100, 7])
@pytest.mark.parametrize("case,b,r,n_class,thr", [
    ("tied_scores", 16, 300, 80, 0.1),
    ("same_box_two_classes", 3, 40, 10, 0.1),
    ("under_thresh", 3, 60, 20, 0.1),
    ("no_valid_image", 3, 30, 5, 0.3),
    ("few_survivors", 2, 100, 20, 0.1),
    ("suppress_most", 2, 200, 2, 0.05),
])
def test_greedy_nms_kernel_index_equals_plain(rng, dev, case, b, r, n_class,
                                              thr, n_post):
    """Kernel 1 with its index output at the post-process's shapes (K=400,
    or fewer candidates) == the plain version, bit for bit: boxes, scores,
    mask and each kept row's index (0 in the slots not kept), one counted
    launch."""
    boxes, scores = (t.to(dev) for t in _offset_rows(rng, b, r, n_class,
                                                      case))
    before = counters["launch.greedy_nms"]
    got = greedy_nms(boxes, scores, n_post=n_post, iou_threshold=thr)
    want = greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                     iou_threshold=thr)
    torch.cuda.synchronize()
    assert counters["launch.greedy_nms"] == before + 1
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].dtype == torch.int32
    if case == "no_valid_image":
        assert int(got[2][1].sum()) == 0 and bool((got[3][1] == 0).all())


@pytest.mark.parametrize("case", ["first_chunk", "crossing"])
def test_greedy_nms_kernel_index_across_chunks(rng, dev, case):
    """Above ``MAX_KERNEL_ROWS`` each chunk's launch counts the index from
    the table's first row: equal to the plain version bit for bit, with
    kept rows past the first chunk where the kept set crosses chunks."""
    b, n_post, k = 2, 300, MAX_KERNEL_ROWS + 1
    if case == "crossing":
        boxes, scores = _crowded_rows(rng, b, k, n_dup=int(0.6 * k))
    else:
        boxes, scores = _sorted_rows(rng, b, k)
    boxes, scores = boxes.to(dev), scores.to(dev)
    got = greedy_nms(boxes, scores, n_post=n_post, iou_threshold=0.7)
    want = greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                     iou_threshold=0.7)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows0 = nms_chunks(k)[0][1]
    if case == "crossing":
        assert int(got[3].max()) >= rows0
    else:
        assert int(got[3].max()) < rows0


def test_proposal_routes_drop_the_index(rng, dev):
    """The proposal routes return three outputs, kernel 1's index dropped:
    the truncated route (one launch of kernel 1 at the flagship's predict
    shape, B=2, K=3000 -> 300) and the whole-table route (kernel 3, whose
    walk stores the index too), each equal to its plain route bit for
    bit."""
    locs, fg, anchors = (t.to(dev) for t in _proposal_data(rng, 2, 20000))
    kw = dict(nms_iou=0.7, n_post_nms=300, min_size=16.0)
    for n_pre_nms, counter in ((3000, "launch.greedy_nms"),
                               (None, "launch.fused_proposals_batched")):
        before = counters[counter]
        got = proposals_batched(locs, fg, anchors, (600, 600),
                                n_pre_nms=n_pre_nms, **kw)
        want = proposals_batched(locs, fg, anchors, (600, 600),
                                 n_pre_nms=n_pre_nms, use_kernel=False, **kw)
        torch.cuda.synchronize()
        assert counters[counter] == before + 1
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_post_process_makes_no_synchronising_call(dev):
    """``FasterRCNN.post_process`` on the card (HarDNet-39 at 160x160, every
    score over the threshold so that its NMS does work) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no call waits for the
    device.  Its class-offset NMS is one launch of kernel 1, and its
    detections equal the plain route's bit for bit."""
    cfg = Config(input_size=(160, 160), score_thresh=0.0)
    model = FasterRCNN(cfg, device=dev)
    images = torch.rand((2, 160, 160, 3), generator=torch.Generator()
                        .manual_seed(0)).to(dev)
    grabbed = []
    post_process = model.post_process

    def grab(*args):
        grabbed.append(args)
        return post_process(*args)

    model.post_process = grab
    model.predict(images)          # warm-up: constants, cluster choice
    del model.post_process
    args = grabbed[0]
    torch.cuda.synchronize()
    before = counters["launch.greedy_nms"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            got = model.post_process(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counters["launch.greedy_nms"] == before + 1
    model.cfg = cfg.replace(pallas="off")
    with torch.inference_mode():
        want = model.post_process(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].sum()) > 0


@pytest.mark.parametrize("dtype,c,r,p,s", [
    (torch.float32, 32, 20, 7, 2), (torch.float32, 300, 20, 7, 2),
    (torch.bfloat16, 256, 20, 7, 2), (torch.bfloat16, 256, 128, 7, 2),
    (torch.bfloat16, 260, 20, 7, 2), (torch.float32, 30, 20, 7, 2),
    (torch.float32, 32, 20, 5, 3), (torch.float32, 32, 20, 14, 2),
    (torch.bfloat16, 256, 100, 14, 2)])
def test_windowed_align_kernel_matches_plain(rng, dev, dtype, c, r, p, s):
    """f32: <= 1e-5 (summation order); bf16: within one bf16 rounding of
    the plain version run in f32 on the same bf16 features.  C=260 bf16 and
    C=30 f32 take 8-byte vectors; P=5, S=3 the kernel's generic loops;
    P=14, S=2 the mask head's instance."""
    hw = [(40, 40), (20, 20), (10, 10), (5, 5)]
    scales = tuple((h / 160.0, w / 160.0) for h, w in hw)
    pyr = [torch.randn(2, h, w, c, device=dev).to(dtype) for h, w in hw]
    x1 = torch.from_numpy(rng.rand(2, r, 2).astype(np.float32) * 170 - 10)
    wh = torch.from_numpy(rng.rand(2, r, 2).astype(np.float32) * 150 + 2)
    rois = torch.cat([x1, x1 + wh], -1).to(dev)
    levels = torch.from_numpy(rng.randint(0, 4, (2, r)).astype(np.int32)).to(dev)
    before = counters["launch.windowed_roi_align_batched"]
    got = windowed_roi_align_batched(pyr, rois, levels, scales, p, s)
    want = windowed_roi_align_batched([t.float() for t in pyr], rois, levels,
                                      scales, p, s, use_kernel=False)
    torch.cuda.synchronize()
    assert counters["launch.windowed_roi_align_batched"] == before + 1
    assert got.shape == (2, r, p, p, c) and got.dtype == dtype
    diff = (got.float() - want).abs()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * want.abs() + 1e-5
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("dtype,c", [(torch.float32, 32),
                                     (torch.bfloat16, 256)])
def test_windowed_align_p14_instance_bitwise_equals_generic(rng, dev, tmp_path,
                                                            dtype, c):
    """The mask head's P=14, S=2 instance (unrolled tap loops) gives the
    bits of the generic instance of the same source (runtime loop bounds,
    built here with the P=14 branch taken out): the same taps and sums in
    the same order.  Against the plain version, whose sums are matrix
    products, it agrees within ``test_windowed_align_kernel_matches_plain``'s
    tolerance, not bit for bit."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_mask_rcnn.py")
    spec = importlib.util.spec_from_file_location("torch_mask_rcnn", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    generic, _ = script.build_generic(str(tmp_path))
    hw = [(40, 52), (20, 26), (10, 13), (5, 7)]
    scales = tuple((h / 160.0, w / 208.0) for h, w in hw)
    pyr = [torch.randn(2, h, w, c, device=dev).to(dtype) for h, w in hw]
    x1 = torch.from_numpy(rng.rand(2, 30, 2).astype(np.float32) * 180 - 10)
    wh = torch.from_numpy(rng.rand(2, 30, 2).astype(np.float32) * 150 + 2)
    rois = torch.cat([x1, x1 + wh], -1).to(dev)
    levels = torch.from_numpy(rng.randint(0, 4, (2, 30)).astype(np.int32)).to(dev)
    got = windowed_roi_align_batched(pyr, rois, levels, scales, 14, 2)
    want = script.launch(generic, pyr, rois, levels, scales, 14)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_mask_head_kernel_route_matches_plain(rng, dev):
    """``FPNMaskHead`` through kernel 2 at P=14 against its plain route (f32
    maps and products, TF32 off): the pooling within 1e-5, so the logits
    within 1e-4 of their largest magnitude; one launch a call."""
    from two_stage_object_detection_tpu_torch.nets.fpn import FPNMaskHead
    from two_stage_object_detection_tpu_torch.models.layers import (
        init_weights)
    head = FPNMaskHead(3, channels=32, dim=16)
    init_weights(head, torch.Generator().manual_seed(1))
    head.to(dev)
    pyr = [torch.randn(2, 32, h, w, device=dev)
           for h, w in ((24, 32), (12, 16), (6, 8), (3, 4), (2, 2))]
    x1 = torch.from_numpy(rng.rand(2, 5, 2).astype(np.float32) * 90)
    wh = torch.from_numpy(rng.rand(2, 5, 2).astype(np.float32) * 40 + 4)
    rois = torch.cat([x1, x1 + wh], -1).to(dev)
    labels = torch.from_numpy(rng.randint(0, 4, (2, 5))).to(dev)
    before = counters["launch.windowed_roi_align_batched"]
    with torch.no_grad():
        got = head(pyr, rois, labels, (96, 128))
        head.use_kernel = False
        want = head(pyr, rois, labels, (96, 128))
    torch.cuda.synchronize()
    assert counters["launch.windowed_roi_align_batched"] == before + 1
    assert got.shape == (2, 5, 28, 28)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_windowed_align_kernel_rejects_misaligned_input(dev):
    """A level whose data does not start on 16 bytes raises (the kernel's
    vector loads need it); nothing is launched."""
    hw = [(8, 8), (4, 4)]
    scales = tuple((h / 32.0, w / 32.0) for h, w in hw)
    pyr = [torch.zeros(1, h, w, 8, device=dev, dtype=torch.bfloat16)
           for h, w in hw]
    pyr[1] = torch.zeros(1 * 4 * 4 * 8 + 1, device=dev,
                         dtype=torch.bfloat16)[1:].view(1, 4, 4, 8)
    rois = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]], device=dev)
    levels = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    before = counters["launch.windowed_roi_align_batched"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        windowed_roi_align_batched(pyr, rois, levels, scales)
    assert counters["launch.windowed_roi_align_batched"] == before


def _proposal_data(rng, b, n, img=600.0):
    """Anchors of 16..200 px, some over the edge; rows 3k/3k+1 share an
    anchor and decode to a pair at IoU ~ 0.7; coarse scores (ties); every
    8th row shrunk under the min size."""
    xy = rng.rand(n, 2) * img * 0.95
    anchors = np.concatenate([xy, xy + rng.rand(n, 2) * 184 + 16], -1)
    anchors[1::3] = anchors[0::3][: len(anchors[1::3])]
    locs = rng.randn(b, n, 4) * 0.3
    locs[:, 0::3] = 0.0
    locs[:, 1::3] = 0.0
    m = locs[:, 1::3].shape[1]
    locs[:, 1::3, 0] = 0.3 / 1.7 * (1.0 + rng.uniform(-1e-5, 1e-5, (b, m)))
    locs[:, 2::8, 2:] = -4.0
    fg = rng.randint(0, 50, size=(b, n)) / 50.0
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (locs, fg, anchors))


@pytest.mark.parametrize("b,n,n_post,signed_zeros", [
    (1, 1, 1, False), (2, 600, 64, False), (3, 5000, 300, False),
    (2, 14336, 40, False), (2, 16368, 300, True), (2, 32768, 40, False),
    (2, 65472, 600, True), (1, 71999, 300, True)])
def test_fused_proposals_kernel_bitwise_equals_plain(rng, dev, b, n, n_post,
                                                     signed_zeros):
    """Kernel 3 == its plain version, bit for bit (torch.equal), over one
    to eight sort chunks and cluster sizes down to the shared-memory floor
    (65,472 and 71,999 rows: the whole-table train route of an FPN input of
    512 px and its largest table); with ``signed_zeros`` all scores but 50
    rows' are -0.0 or +0.0, which the plain argmax holds equal, so most
    kept rows come from those ties."""
    locs, fg, anchors = (t.to(dev) for t in _proposal_data(rng, b, n))
    if signed_zeros:
        zeros = torch.from_numpy(np.where(rng.rand(b, n) < 0.5, -0.0, 0.0)
                                 .astype(np.float32)).to(dev)
        fg = torch.where(torch.arange(n, device=dev) % (n // 50) == 0, fg,
                         zeros)
    kw = dict(nms_iou=0.7, n_post_nms=n_post, min_size=16.0)
    before = counters["launch.fused_proposals_batched"], counters["launch.greedy_nms"]
    got = fused_proposals_batched(locs, fg, anchors, (600, 600), **kw)
    want = fused_proposals_rows_reference(locs, fg, anchors, (600, 600), **kw)
    torch.cuda.synchronize()
    assert counters["launch.fused_proposals_batched"] == before[0] + 1
    assert counters["launch.greedy_nms"] == before[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if signed_zeros:
        kept = got[1][got[2]]
        assert bool((kept == 0).any() & torch.signbit(kept).any())


def test_fused_proposals_one_image_kernel(rng, dev):
    """Kernel 4 (the B=1 launch) == the plain version, bit for bit."""
    locs, fg, anchors = (t.to(dev) for t in _proposal_data(rng, 1, 2000))
    kw = dict(nms_iou=0.7, n_post_nms=100, min_size=16.0)
    before = counters["launch.fused_proposals"]
    got = fused_proposals(locs[0], fg[0], anchors, (600, 600), **kw)
    want = fused_proposals_rows_reference(locs, fg, anchors, (600, 600), **kw)
    torch.cuda.synchronize()
    assert counters["launch.fused_proposals"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


def test_fpn_256_predict_proposals_take_kernel_3(rng, dev):
    """The flagship recipe at 256x256: 16,368 anchors, under 6 * 3000, so
    predict takes the whole-table route, with more rows than shared memory
    holds.  Equal to the plain route, bit for bit."""
    cfg = Config(fpn=True, backbone="resnet50", loc_normalize=True,
                 input_size=(256, 256))
    anchors = torch.from_numpy(make_fpn_anchors(cfg)).to(dev)
    n = anchors.shape[0]
    assert 14336 < n < 6 * cfg.n_test_pre_nms
    locs = torch.from_numpy((rng.randn(2, n, 4) * 0.2).astype(np.float32))
    fg = torch.from_numpy((rng.randint(0, 50, size=(2, n)) / 50.0)
                          .astype(np.float32))
    kw = dict(nms_iou=cfg.rpn_nms_iou, n_post_nms=cfg.n_test_post_nms,
              min_size=cfg.proposal_min_size, n_pre_nms=cfg.n_test_pre_nms)
    locs, fg = locs.to(dev), fg.to(dev)
    before = counters["launch.fused_proposals_batched"]
    got = proposals_batched(locs, fg, anchors, (256, 256), **kw)
    want = proposals_batched(locs, fg, anchors, (256, 256), use_kernel=False,
                             **kw)
    torch.cuda.synchronize()
    assert counters["launch.fused_proposals_batched"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("n", [MAX_KERNEL_ROWS + 1, 250000])
@pytest.mark.parametrize("case", ["first_chunk", "crossing"])
def test_fused_proposals_kernel_above_the_row_cap(rng, dev, n, case):
    """Kernel 3 above the rows one walk launch holds: launch A sorts 7
    (112,129 rows) or 16 (250,000) chunks of 16,384 keys, more than the 8
    it aims for, and the walk runs in chunks; equal to the plain version
    bit for bit, one counted launch.  ``"first_chunk"``: ``n_post`` is
    filled inside the walk's first chunk; ``"crossing"``: the best 70% of
    the anchors are 1 px jitters of 6 boxes, so the first chunk keeps at
    most 6 and the later ones the rest."""
    b, n_post = 2, 300
    locs, fg, anchors = _proposal_data(rng, b, n)
    if case == "crossing":
        n_dup = int(0.7 * n)
        base = rng.rand(6, 2) * 400.0
        xy = base[rng.randint(0, 6, n_dup)] + rng.rand(n_dup, 2)
        anchors[:n_dup] = torch.from_numpy(np.concatenate(
            [xy, xy + 100.0 + rng.rand(n_dup, 2)], -1).astype(np.float32))
        locs[:, :n_dup] = 0.0
        fg[:, :n_dup] = torch.from_numpy(
            (0.5 + rng.rand(b, n_dup) * 0.5).astype(np.float32))
        fg[:, n_dup:] *= 0.5
    locs, fg, anchors = locs.to(dev), fg.to(dev), anchors.to(dev)
    kw = dict(nms_iou=0.7, n_post_nms=n_post, min_size=16.0)
    before = counters["launch.fused_proposals_batched"]
    got = fused_proposals_batched(locs, fg, anchors, (600, 600), **kw)
    want = fused_proposals_rows_reference(locs, fg, anchors, (600, 600), **kw)
    torch.cuda.synchronize()
    assert counters["launch.fused_proposals_batched"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rows0 = nms_chunks(n)[0][1]
    boxes, scores = sorted_rows_reference(*_decode_masked(
        locs, fg, anchors, (600, 600), 16.0))
    first = greedy_nms_rows_reference(boxes[:, :rows0], scores[:, :rows0],
                                      n_post=n_post, iou_threshold=0.7)[2]
    if case == "crossing":
        assert bool((first.sum(1) <= 6).all())
    else:
        assert bool((first.sum(1) == n_post).all())
    assert bool((got[2].sum(1) == n_post).all())


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 300),
                                     (torch.bfloat16, 4), (torch.bfloat16, 512)])
def test_roi_pool_kernel_equals_plain(rng, dev, dtype, c):
    """Kernel 5 == its plain version: pooled values and argmax equal
    (max is exact; bf16 maps are pooled in f32)."""
    feats = torch.from_numpy((rng.randint(-8, 8, size=(2, 12, 10, c)) / 4.0)
                             .astype(np.float32))
    feats[:, 2:7, 1:6] = 0.75                          # a tied patch
    xy = rng.rand(2, 30, 2) * np.array([160, 192]) * 1.1 - 16
    rois = np.concatenate([xy, xy + rng.rand(2, 30, 2) * 120 + 2], -1)
    rois[:, 0] = [-400, -300, -200, -100]              # off the map
    rois[:, 1] = [-40, 16, 24, 80]                     # empty first bins
    rois = torch.from_numpy(rois.astype(np.float32)).to(dev)
    feats = feats.to(dev, dtype)
    before = counters["launch.roi_pool_max"]
    got = roi_pool_max(feats, rois, 7, 1.0 / 16)
    want = roi_pool_argmax(feats, rois, 7, 1.0 / 16)
    torch.cuda.synchronize()
    assert counters["launch.roi_pool_max"] == before + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][:, 0] == -1).all() and (got[1][:, 1] == -1).any()


@pytest.mark.parametrize("b,h,w,c,dtype,route", [
    (1, 38, 38, 12, torch.float32, "slice"),
    (1, 38, 38, 512, torch.bfloat16, "slice"),
    (2, 38, 38, 260, torch.bfloat16, "slice"),
    (1, 130, 120, 8, torch.bfloat16, "direct"),
    (1, 130, 120, 4, torch.float32, "direct")])
def test_roi_pool_kernel_routes_equal_plain(rng, dev, b, h, w, c, dtype, route):
    """Kernel 5 on both routes == its plain version, values and argmax,
    with and without the index store: one image (roi chunks that reload
    the slice), f32 C=12, bf16 C=260 (8-byte vectors, 65 slices), and maps
    too big for shared memory (the direct scan)."""
    assert roi_pool_plan(b, h, w, c, 40, torch.finfo(dtype).bits // 8,
                         132)["route"] == route
    feats = torch.from_numpy((rng.randint(-8, 8, size=(b, h, w, c)) / 4.0)
                             .astype(np.float32))
    feats[:, 2:9, 1:6] = 0.75
    xy = rng.rand(b, 40, 2) * np.array([w, h]) * 16 * 1.1 - 16
    rois = np.concatenate([xy, xy + rng.rand(b, 40, 2) * np.array([w, h])
                           * 12 + 2], -1)
    rois[:, 0] = [-400, -300, -200, -100]
    rois = torch.from_numpy(rois.astype(np.float32)).to(dev)
    feats = feats.to(dev, dtype)
    got = roi_pool_max(feats, rois, 7, 1.0 / 16)
    values, none = roi_pool_max(feats, rois, 7, 1.0 / 16, with_argmax=False)
    want = roi_pool_argmax(feats, rois, 7, 1.0 / 16)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert none is None and torch.equal(values, want[0])
    assert (got[1][:, 0] == -1).all() and (got[1] >= 0).any()


def test_roi_pool_kernel_rejects_bad_input(dev):
    rois = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        roi_pool_max(torch.zeros((1, 4, 4, 6), device=dev), rois)
    with pytest.raises(ValueError, match="f32 or bf16"):
        roi_pool_max(torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.float16),
                     rois)


def _pool_case(rng, dev, dtype, c):
    """A ReLU-like map (half zeros, coarse values, a tied patch), rois with
    one off the map and one with empty first bins, and a cotangent whose
    third roi is all zero."""
    feats = torch.from_numpy((np.maximum(rng.randint(-8, 8, size=(2, 12, 10, c)),
                                         0) / 4.0).astype(np.float32))
    feats[:, 2:7, 1:6] = 0.75
    xy = rng.rand(2, 30, 2) * np.array([160, 192]) * 1.1 - 16
    rois = np.concatenate([xy, xy + rng.rand(2, 30, 2) * 120 + 2], -1)
    rois[:, 0] = [-400, -300, -200, -100]
    rois[:, 1] = [-40, 16, 24, 80]
    g = rng.randn(2, 30, 7, 7, c).astype(np.float32)
    g[:, 2] = 0.0
    return (feats.to(dev, dtype), torch.from_numpy(rois.astype(np.float32)).to(dev),
            torch.from_numpy(g).to(dev))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 300),
                                     (torch.bfloat16, 4), (torch.bfloat16, 512)])
def test_roi_pool_bwd_kernel_matches_plain(rng, dev, dtype, c):
    """Kernel 6 == its plain version up to the order of its atomic adds:
    within 1e-5 of each cell's sum of |g| (plus one bf16 ulp of the result
    from a bf16 map), ties and empty bins included; the result is in the
    map's dtype; one launch is counted."""
    feats, rois, g = _pool_case(rng, dev, dtype, c)
    before = counters["launch.roi_pool_bwd_recompute"]
    got = roi_pool_bwd_recompute(feats, rois, g, 7, 1.0 / 16)
    want = roi_pool_grad_first_argmax(feats, rois, g, 7, 1.0 / 16)
    torch.cuda.synchronize()
    assert counters["launch.roi_pool_bwd_recompute"] == before + 1
    assert got.dtype == want.dtype == dtype and got.shape == feats.shape
    argmax = roi_pool_argmax(feats, rois, 7, 1.0 / 16)[1]
    mass = scatter_argmax_grad(argmax, g.abs(), 12, 10)
    tol = 1e-5 * mass + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert bool((want != 0).any())


def test_roi_pool_backward_kernels_through_autograd(rng, dev):
    """``roi_pool_fast`` (backward: kernel 6) and ``roi_pool_max`` (backward:
    the scatter kernel over the saved argmax) give the gradient of the
    plain versions, and each counts its launch."""
    feats, rois, g = _pool_case(rng, dev, torch.float32, 16)
    want = roi_pool_grad_first_argmax(feats, rois, g, 7, 1.0 / 16)
    counts = (counters["launch.roi_pool_bwd_recompute"], counters["launch.roi_pool_bwd_scatter"])
    f = feats.clone().requires_grad_(True)
    (roi_pool_fast(f, rois, 7, 1.0 / 16) * g).sum().backward()
    assert counters["launch.roi_pool_bwd_recompute"] == counts[0] + 1
    torch.testing.assert_close(f.grad, want, rtol=0, atol=1e-4)
    f = feats.clone().requires_grad_(True)
    pooled, argmax = roi_pool_max(f, rois, 7, 1.0 / 16)
    (pooled * g).sum().backward()
    torch.cuda.synchronize()
    assert counters["launch.roi_pool_bwd_scatter"] == counts[1] + 1
    torch.testing.assert_close(f.grad, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(roi_pool_bwd_scatter(argmax, g, 12, 10),
                               scatter_argmax_grad(argmax, g, 12, 10),
                               rtol=0, atol=1e-4)


def _bwd_case(rng, dev, b, h, w, c, dtype, r=40):
    """A ReLU-like ``[b, h, w, c]`` map (half zeros, coarse values, a tied
    patch); ``r`` rois over it at stride 16, roi 0 off the map and roi 1
    with empty first bins; a cotangent whose third roi is all zero."""
    feats = torch.from_numpy((np.maximum(rng.randint(-8, 8, size=(b, h, w, c)),
                                         0) / 4.0).astype(np.float32))
    feats[:, 2:9, 1:6] = 0.75
    xy = rng.rand(b, r, 2) * np.array([w, h]) * 16 * 1.1 - 16
    rois = np.concatenate([xy, xy + rng.rand(b, r, 2) * np.array([w, h])
                           * 10 + 2], -1)
    rois[:, 0] = [-400, -300, -200, -100]
    rois[:, 1, :2] = -40
    g = rng.randn(b, r, 7, 7, c).astype(np.float32)
    g[:, 2] = 0.0
    return (feats.to(dev, dtype),
            torch.from_numpy(rois.astype(np.float32)).to(dev),
            torch.from_numpy(g).to(dev))


def _bwd_tol(feats, rois, g, want):
    """1e-5 of each cell's sum of |g| + 1e-6, plus one bf16 ulp of the
    result from a bf16 map: the adds collide in no fixed order."""
    argmax = roi_pool_argmax(feats, rois, 7, 1.0 / 16)[1]
    mass = scatter_argmax_grad(argmax, g.abs(), *feats.shape[1:3])
    tol = 1e-5 * mass + 1e-6
    if feats.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return argmax, tol


# (b, h, w, c, dtype, route): the RoI head's map in bf16 and f32, 8-byte
# vectors of 4 bf16 with a ragged last slice of one vector (C=260 bf16:
# plain loads, not bulk copies), the smallest C, and a map too large for
# any slice
BWD_ROUTES = [(2, 38, 38, 512, torch.bfloat16, "slice"),
              (2, 38, 38, 512, torch.float32, "slice"),
              (4, 38, 38, 260, torch.bfloat16, "slice"),
              (2, 12, 10, 4, torch.float32, "slice"),
              (1, 130, 120, 8, torch.bfloat16, "direct"),
              (1, 130, 120, 8, torch.float32, "direct")]


@pytest.mark.parametrize("b,h,w,c,dtype,route", BWD_ROUTES)
def test_roi_pool_bwd_kernels_match_plain_on_each_route(rng, dev, b, h, w, c,
                                                        dtype, route):
    """Kernel 6 and kernel 5b on the route the plan gives, against their
    plain versions within the tolerance of ``_bwd_tol``: empty bins and an
    all-zero cotangent roi add nothing; kernel 6 returns the map's dtype,
    5b f32; one launch each is counted."""
    elem = torch.finfo(dtype).bits // 8
    for kind in ("recompute", "scatter"):
        assert roi_pool_bwd_plan(kind, b, h, w, c, 40, elem if kind ==
                                 "recompute" else 4)["route"] == route
    feats, rois, g = _bwd_case(rng, dev, b, h, w, c, dtype)
    counts = (counters["launch.roi_pool_bwd_recompute"], counters["launch.roi_pool_bwd_scatter"])
    got6 = roi_pool_bwd_recompute(feats, rois, g, 7, 1.0 / 16)
    want6 = roi_pool_grad_first_argmax(feats, rois, g, 7, 1.0 / 16)
    argmax, tol = _bwd_tol(feats, rois, g, want6)
    got5 = roi_pool_bwd_scatter(argmax, g, h, w)
    want5 = scatter_argmax_grad(argmax, g, h, w)
    torch.cuda.synchronize()
    assert (counters["launch.roi_pool_bwd_recompute"], counters["launch.roi_pool_bwd_scatter"]) \
        == (counts[0] + 1, counts[1] + 1)
    assert got6.dtype == dtype and got5.dtype == torch.float32
    assert bool(((got6.float() - want6.float()).abs() <= tol).all())
    tol5 = 1e-5 * scatter_argmax_grad(argmax, g.abs(), h, w) + 1e-6
    assert bool(((got5 - want5).abs() <= tol5).all())
    assert bool((want6 != 0).any()) and bool((argmax < 0).any())


@pytest.mark.parametrize("b,h,w,c,dtype,route", BWD_ROUTES)
def test_roi_pool_bwd_kernels_through_autograd_on_each_route(
        rng, dev, b, h, w, c, dtype, route):
    """``roi_pool_fast`` (backward: kernel 6) and ``roi_pool_max``
    (backward: kernel 5b over the saved argmax) give the plain versions'
    gradient on each route, in the map's dtype."""
    feats, rois, g = _bwd_case(rng, dev, b, h, w, c, dtype)
    want = roi_pool_grad_first_argmax(feats, rois, g, 7, 1.0 / 16)
    _, tol = _bwd_tol(feats, rois, g, want)
    for pool in (lambda f: roi_pool_fast(f, rois, 7, 1.0 / 16),
                 lambda f: roi_pool_max(f, rois, 7, 1.0 / 16)[0]):
        f = feats.clone().requires_grad_(True)
        (pool(f) * g).sum().backward()
        torch.cuda.synchronize()
        assert f.grad.dtype == dtype
        assert bool(((f.grad.float() - want.float()).abs() <= tol).all())


def test_roi_pool_kernel_skips_the_index_store(rng, dev):
    """Without a backward to follow, kernel 5 gets no index buffer: the
    values are the same and no index comes back."""
    feats, rois, _ = _pool_case(rng, dev, torch.bfloat16, 32)
    both = roi_pool_max(feats, rois, 7, 1.0 / 16)
    with torch.inference_mode():
        values, none = roi_pool_max(feats, rois, 7, 1.0 / 16, with_argmax=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(values, both[0])


def test_roi_pool_bwd_kernels_reject_bad_input(dev):
    rois = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        roi_pool_bwd_recompute(torch.zeros((1, 4, 4, 6), device=dev), rois,
                               torch.zeros((1, 2, 7, 7, 6), device=dev))
    with pytest.raises(ValueError, match="g must have shape"):
        roi_pool_bwd_recompute(torch.zeros((1, 4, 4, 8), device=dev), rois,
                               torch.zeros((1, 2, 5, 5, 8), device=dev))
    with pytest.raises(ValueError, match="multiple of 4"):
        roi_pool_bwd_scatter(torch.zeros((1, 2, 7, 7, 6), device=dev,
                                         dtype=torch.int32),
                             torch.zeros((1, 2, 7, 7, 6), device=dev), 4, 4)


def test_custom_ops_pass_opcheck(rng, dev):
    """The predict path's kernels as ``torch.library`` custom ops (kernels
    1, 2, 3 and 5, with and without the index): schema, fake
    implementation and dispatch pass ``torch.library.opcheck``, and a call
    of each op equals the plain version bit for bit (kernel 2 within 1e-5)
    and counts one launch."""
    boxes, scores = (t.to(dev) for t in _sorted_rows(rng, 3, 700))
    torch.library.opcheck(greedy_nms_op, (boxes, scores, 60, 0.7))
    want = greedy_nms_rows_reference(boxes, scores, n_post=60,
                                     iou_threshold=0.7)
    before = counters["launch.greedy_nms"]
    for g, w in zip(greedy_nms_op(boxes, scores, 60, 0.7), want):
        assert torch.equal(g, w)
    assert counters["launch.greedy_nms"] == before + 1

    locs, fg, anchors = (t.to(dev) for t in _proposal_data(rng, 2, 600))
    args = (locs, fg, anchors, 600.0, 600.0, 0.7, 64, 16.0)
    torch.library.opcheck(fused_proposals_op, args)
    want = fused_proposals_rows_reference(locs, fg, anchors, (600.0, 600.0),
                                          nms_iou=0.7, n_post_nms=64,
                                          min_size=16.0)
    before = counters["launch.fused_proposals_batched"]
    for g, w in zip(fused_proposals_op(*args), want):
        assert torch.equal(g, w)
    assert counters["launch.fused_proposals_batched"] == before + 1

    hw = [(40, 40), (20, 20), (10, 10), (5, 5)]
    pyr = [torch.randn(2, h, w, 32, device=dev) for h, w in hw]
    scales = [v for h, w in hw for v in (h / 160.0, w / 160.0)]
    x1 = torch.from_numpy(rng.rand(2, 20, 2).astype(np.float32) * 150)
    rois = torch.cat([x1, x1 + 8 + 60 * torch.from_numpy(
        rng.rand(2, 20, 2).astype(np.float32))], -1).to(dev)
    levels = torch.from_numpy(rng.randint(0, 4, (2, 20)).astype(np.int32)
                              ).to(dev)
    args = (pyr, rois, levels, scales, 7, 2, 32, False)
    torch.library.opcheck(windowed_align_op, args)
    before = counters["launch.windowed_roi_align_batched"]
    got = windowed_align_op(*args)
    want = windowed_roi_align_batched(pyr, rois, levels, [
        (h / 160.0, w / 160.0) for h, w in hw], use_kernel=False)
    assert float((got - want).abs().max()) <= 1e-5
    assert counters["launch.windowed_roi_align_batched"] == before + 1

    feats = torch.from_numpy((rng.randint(-8, 8, size=(2, 12, 10, 8)) / 4.0)
                             .astype(np.float32)).to(dev)
    xy = rng.rand(2, 30, 2) * 150
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rng.rand(2, 30, 2) * 100 + 2], -1).astype(np.float32)
    ).to(dev)
    want = roi_pool_argmax(feats, rois, 7, 1.0 / 16)
    for op, n_out in ((roi_pool_values_op, 1), (roi_pool_argmax_op, 2)):
        torch.library.opcheck(op, (feats, rois, 7, 1.0 / 16))
        before = counters["launch.roi_pool_max"]
        got = op(feats, rois, 7, 1.0 / 16)
        got = (got,) if n_out == 1 else got
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert counters["launch.roi_pool_max"] == before + 1


@pytest.mark.parametrize("n,c,hw,o,k,stride,pad", [
    (16, 3, 64, 64, 7, 2, 3),      # the stem: K = 147, padded to 152
    (2, 64, 20, 64, 3, 1, 1),
    (1, 32, 3, 12, 1, 1, 0),       # M = 9 <= 16 rows, N = 12 channels
    (2, 512, 10, 512, 3, 1, 1)])
def test_int8_conv_int_mm_equals_float64(rng, dev, n, c, hw, o, k, stride,
                                         pad):
    """``quantize.conv_int32`` on the card (im2col + ``torch._int_mm``, rows,
    depth and channels padded to what it takes) equals the float64
    convolution of the same int8 values, and is channels-last in memory."""
    x = torch.from_numpy(rng.randint(-127, 128, (n, c, hw, hw))
                         .astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.randint(-127, 128, (o, c, k, k))
                         .astype(np.int8)).to(dev)
    got = conv_int32(x, w, stride, pad)
    want = conv_int32_reference(x, w, stride, pad)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["none", "relu6", "prelu"])
@pytest.mark.parametrize("c", [26, 82, 256, 410, 1024])
def test_conv_epilogue_kernel_bitwise_equals_plain(dev, c, act, residual,
                                                   dtype):
    """The conv epilogue, in place on a channels-last map, equals its plain
    version bit for bit at HarDNet's and ResNet's widths (16-byte vectors
    where a pixel's bytes allow, 4-byte pairs at 26, 82 and 410 in bf16) on
    odd pixel counts (3 x 7 x 5), with NaN and the clamp's edges among the
    values; the launch is counted and writes into ``y``."""
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(c)
    y = (torch.randn(3, c, 7, 5, device=dev, generator=gen) * 4).to(dtype)
    y = y.contiguous(memory_format=cl)
    y[0, 0, 0, :3] = torch.tensor([float("nan"), 6.0, 0.0])
    r = (torch.randn(y.shape, device=dev, generator=gen).to(dtype)
         .contiguous(memory_format=cl) if residual else None)
    bias = torch.randn(c, device=dev, generator=gen)
    slope = torch.full((1,), 0.1, device=dev)
    want = conv_epilogue_reference(y, bias, r, act, slope)
    before = counters["launch.conv_epilogue"]
    out = y.clone(memory_format=cl)
    got = conv_epilogue(out, bias, r, act, slope)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert counters["launch.conv_epilogue"] == before + 1


@pytest.mark.parametrize("c,act,residual", [
    (26, "relu6", False), (410, "relu6", False), (410, "prelu", True),
    (256, "prelu", True)])
def test_conv_epilogue_kernel_bitwise_over_grid_strides(dev, c, act,
                                                       residual):
    """The epilogue on a bf16 map of 1.2 to 3.0 million vectors, 1.1 to 11
    passes of its grid on the H100 (132 SMs x 8 blocks x 256 threads, each
    taking as many vectors as make 16 bytes), so that every thread steps
    its channel from pass to pass and the last pass is partial: bit for bit
    its plain version, at two of HarDNet's 4-byte-pair widths and at a
    16-byte one."""
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(c)
    shape = (5, c, 37, 41) if c == 410 else (9, c, 101, 103)
    y = (torch.randn(shape, device=dev, generator=gen) * 4).to(
        torch.bfloat16).contiguous(memory_format=cl)
    r = (torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
         .contiguous(memory_format=cl) if residual else None)
    bias = torch.randn(c, device=dev, generator=gen)
    slope = torch.full((1,), 0.1, device=dev)
    want = conv_epilogue_reference(y, bias, r, act, slope)
    got = conv_epilogue(y.clone(memory_format=cl), bias, r, act, slope)
    assert torch.equal(got, want)


def _randomised_norms(model, seed=0):
    """Batch-norm scales, shifts and running statistics away from their
    initial 1 / 0, so that the fold is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)


@pytest.mark.parametrize("name,cfg", [
    ("hardnet39", Config()),
    ("resnet50_fpn", Config(fpn=True, backbone="resnet50",
                            input_size=(800, 1088)))])
def test_folded_features_match_unfolded(rng, dev, name, cfg):
    """``features`` of HarDNet-39 at 600x600 and of ResNet-50-FPN at
    800x1088, B=2, bf16: the folded route (inference mode) against the
    unfolded one (the same eval-mode model with gradients on), each beside
    the float32 model's features.  Every conv + batch-norm pair folds, and
    the folded route is as near the float32 features as the unfolded one:
    each rounds in bf16, at other places."""
    model = FasterRCNN(cfg, seed=0)
    _randomised_norms(model)
    ref = FasterRCNN(cfg.replace(compute_dtype="float32"), seed=0)
    ref.load_state_dict(model.state_dict())
    h, w = cfg.input_size
    x = torch.from_numpy(rng.rand(2, h, w, 3).astype(np.float32)).to(dev)
    counters.clear()
    with torch.inference_mode():
        folded = model.features(x)
    pairs = sum(isinstance(m, BatchNorm) for m in model.extractor.modules())
    assert counters["fold.folded"] == pairs
    with torch.enable_grad():
        unfolded = model.features(x)
        want = ref.features(x)
    assert counters["fold.folded"] == pairs
    assert counters["fold.fallback.grad"] == 2
    maps = lambda t: t if isinstance(t, tuple) else (t,)
    for f, u, r in zip(maps(folded), maps(unfolded), maps(want)):
        scale = float(r.abs().max())
        err_f = float((f.float() - r).abs().max()) / scale
        err_u = float((u.detach().float() - r.detach()).abs().max()) / scale
        print(f"{name} {tuple(r.shape)}: folded {err_f:.3e}, unfolded "
              f"{err_u:.3e} of the f32 map's largest magnitude")
        assert err_f <= 1.5 * err_u + 1e-3


def _store_case(dev, dtype, c, stride, n_dest, n=2, h=37, w=41, seed=0):
    """x, weight, bias and ``n_dest`` destinations of a depth-wise store,
    the buffers filled with NaN: one destination is a tensor of its own
    (offset 0, pitch C); more are buffers wider than C at offsets that are
    odd multiples of 2 (4-byte pairs in bf16)."""
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 3).to(
        dtype).contiguous(memory_format=cl)
    wt = torch.randn(c, 1, 3, 3, device=dev, generator=gen).to(dtype)
    bias = torch.randn(c, device=dev, generator=gen)
    ho, wo = out_size(h, w, stride)
    places = ([(0, c)] if n_dest == 1 else
              [(2 * (2 * k + 1), 2 * (2 * k + 1) + c + 2 * k)
               for k in range(n_dest)])
    dests = [(torch.full((n, pitch, ho, wo), float("nan"), device=dev,
                         dtype=dtype).contiguous(memory_format=cl), off)
             for off, pitch in places]
    return x, wt, bias, dests


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_dest", [1, 2, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [26, 82, 102, 410, 1024])
def test_depthwise_store_kernel_bitwise_equals_plain(dev, c, stride, n_dest,
                                                     dtype):
    """The depth-wise store at HarDNet-39's widths (26, 82, 102, 410 in
    4-byte pairs in bf16; 1024 in 16-byte vectors into a tensor of its
    own), both strides, one to five destinations at offsets that are odd
    multiples of 2, on a 37 x 41 map (ragged tiles): each destination's
    slice equals the plain version's bit for bit, with a bias on one and
    five destinations and none on two; the channels outside the slices
    are untouched; one launch counted."""
    x, wt, bias, dests = _store_case(dev, dtype, c, stride, n_dest)
    b = None if n_dest == 2 else bias
    want = [(buf.clone(), off) for buf, off in dests]
    depthwise_store_reference(x, wt, stride, b, want)
    before = counters["launch.depthwise_store"]
    depthwise_store(x, wt, stride, b, dests)
    torch.cuda.synchronize()
    assert counters["launch.depthwise_store"] == before + 1
    for (got, off), (ref, _) in zip(dests, want):
        assert torch.equal(got[:, off:off + c], ref[:, off:off + c])
        assert torch.equal(got.isnan(), ref.isnan())


@pytest.mark.parametrize("c,stride,places", [
    (48, 2, [(0, 48), (16, 64), (42, 90)]),       # stem2 into block0
    (26, 1, [(0, 26), (16, 82)]),                 # block0's output 2
    (640, 1, [(0, 640), (160, 800), (416, 1056)]),  # down2 into block3
    (132, 1, [(160, 292)])])                      # block1's last output
def test_depthwise_store_kernel_at_hardnet39_bucket_shapes(dev, c, stride,
                                                           places):
    """HarDNet-39's depth-wise layers at a bucket's shape (B=16, 600x600
    input: 150x150 maps, the stem's from 300x300), each into its real
    destinations (offsets and buffer widths from the blocks' tables), bf16,
    no bias (the route defers it): bit for bit the plain version, over
    grids of thousands of blocks."""
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(c)
    hw = 300 if stride == 2 else 150
    x = (torch.randn(16, c, hw, hw, device=dev, generator=gen) * 2).to(
        torch.bfloat16).contiguous(memory_format=cl)
    wt = torch.randn(c, 1, 3, 3, device=dev, generator=gen).to(torch.bfloat16)
    dests = [(torch.empty(16, pitch, 150, 150, device=dev,
                          dtype=torch.bfloat16, memory_format=cl), off)
             for off, pitch in places]
    depthwise_store(x, wt, stride, None, dests)
    y = torch.empty(16, c, 150, 150, device=dev, dtype=torch.bfloat16,
                    memory_format=cl)
    depthwise_store_reference(x, wt, stride, None, [(y, 0)])
    for buf, off in dests:
        assert torch.equal(buf[:, off:off + c], y)


def test_depthwise_store_rejects_bad_input(dev):
    """The wrapper raises on what the kernel does not take: stride 3,
    no or nine destinations, float16, a weight of another dtype, a bias
    not float32, a destination not channels-last, of the wrong map size,
    too narrow at its offset, or overlapping ``x``."""
    x, wt, bias, dests = _store_case(dev, torch.bfloat16, 26, 1, 2)
    buf, off = dests[1]
    bad = {
        "stride 1 or 2": dict(stride=3),
        "1 to 8 destinations": dict(dests=[]),
        "1 to 8 destinations ": dict(dests=[dests[0]] * 9),
        "f32 or bf16": dict(x=x.half(), wt=wt.half()),
        "weight must be": dict(wt=wt.float()),
        "bias must be": dict(bias=bias.to(torch.bfloat16)),
        "channels-last": dict(dests=[(buf.contiguous(), off)]),
        "cannot hold": dict(dests=[(torch.empty(
            2, buf.shape[1], 36, 41, device=dev, dtype=torch.bfloat16,
            memory_format=torch.channels_last), off)]),
        "cannot hold ": dict(dests=[(buf, buf.shape[1] - 25)]),
        "overlaps x": dict(dests=[(x, 0)]),
    }
    for match, kw in bad.items():
        args = dict(x=x, wt=wt, stride=1, bias=bias, dests=dests)
        args.update(kw)
        with pytest.raises(ValueError, match=match.strip()):
            depthwise_store(args["x"], args["wt"], args["stride"],
                            args["bias"], args["dests"])


def test_store_route_trunk_matches_the_cat_route(rng, dev):
    """HarDNet-39's folded trunk at a bucket's shape (B=2, 600x600, bf16):
    the store route launches the depth-wise store once a depth-wise layer
    (36) and makes no ``torch.cat``; the cat route (as under a row shard:
    cuDNN's depth-wise conv, then 20 ``torch.cat``s) none and 20.

    Tolerance.  The two routes differ only in the depth-wise convs: the
    kernel sums the nine products in float32 in its own order and rounds
    once, cuDNN in its order.  So each depth-wise layer's output, on the
    input the cat route gave it, is within one bf16 rounding of cuDNN's:
    at most one bf16 step (2^-8 to 2^-7 of the value) apart.  Past the
    first layer the routes' inputs differ by those roundings too, so the
    trunk is held as :func:`test_folded_features_match_unfolded` holds
    it: its features as near the float32 model's as the cat route's
    (1.5 times the cat route's error, plus 1e-3 of the largest
    magnitude)."""
    cfg = Config()
    model = FasterRCNN(cfg, seed=0)
    _randomised_norms(model)
    ref = FasterRCNN(cfg.replace(compute_dtype="float32"), seed=0)
    ref.load_state_dict(model.state_dict())
    h, w = cfg.input_size
    x = torch.from_numpy(rng.rand(2, h, w, 3).astype(np.float32)).to(dev)
    seen = []
    run_folded = hardnet.DWConvLayer._run_folded

    def keep(layer, inp, params, defer, into=None):
        if into is None:
            seen.append((layer, inp, params, defer))
        return run_folded(layer, inp, params, defer, into)

    counters.clear()
    with torch.inference_mode():
        stored = model.features(x)
        assert counters["launch.depthwise_store"] == 36
        assert counters["hardnet.cat"] == 0
        counters.clear()
        with mock.patch.object(hardnet, "spatial", types.SimpleNamespace(
                current=lambda: object())), \
                mock.patch.object(hardnet.DWConvLayer, "_run_folded", keep):
            catted = model.features(x)
        assert counters["launch.depthwise_store"] == 0
        assert counters["hardnet.cat"] == 20
        assert len(seen) == 36
        for layer, inp, (wt, b), defer in seen:
            cudnn = layer.dwconv.forward(inp, wt)
            own = torch.empty_like(cudnn, memory_format=torch.channels_last)
            depthwise_store(inp, wt, layer.dwconv.stride, None, [(own, 0)])
            a, c = own.float(), cudnn.float()
            _, e = torch.frexp(torch.maximum(a.abs(), c.abs()))
            step = torch.ldexp(torch.ones_like(a), e - 8)
            assert bool(((a - c).abs() <= step).all())
    with torch.enable_grad():
        want = ref.features(x)
    scale = float(want.abs().max())
    err_s = float((stored.float() - want).abs().max()) / scale
    err_c = float((catted.float() - want).abs().max()) / scale
    print(f"store route {err_s:.3e}, cat route {err_c:.3e} of the f32 "
          "map's largest magnitude")
    assert err_s <= 1.5 * err_c + 1e-3
