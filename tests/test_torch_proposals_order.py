"""PyTorch port: kernel 3's order, kernel 1's cluster bounds and kernel 5's
slice plan, on the CPU.

Kernel 3 (``fused_proposals_batched``) runs as two launches on the card:
launch A (``csrc/proposals.cu``) decodes and masks every anchor and sorts
each image's rows by a unique 64-bit key (score descending, -0.0 taken as
+0.0, then the row index ascending), and launch B is kernel 1's greedy walk
(``csrc/nms.cu``) over the sorted rows.  Here the plain versions of those
two launches (``order_keys``, ``sorted_rows_reference``, composed in
:func:`fused_proposals_sorted_reference`) are held, bit for bit, against
kernel 3's plain version (``fused_proposals_rows_reference``: argmax steps
with no sort) and against the JAX package's ``_batched_kernel`` run
interpreted.
Then the Python that plans the launches: kernel 1's cluster bounds (a block
holds at most 219 tiles of 64 rows in shared memory) and kernel 5's map
slices (``roi_pool_plan``).  The kernels themselves run only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.ops.pallas_proposals import (
    fused_proposals_batched as j_fused_batched)
from two_stage_object_detection_tpu_torch.ops import proposals as tp
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    EDGE_BYTES, SLICE_SMEM_BYTES, roi_pool_plan)

T = torch.from_numpy
IMG = (128, 160)          # (H, W)
KW = dict(nms_iou=0.7, min_size=8.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fused_proposals_sorted_reference(rpn_locs: torch.Tensor,
                                     rpn_fg_scores: torch.Tensor,
                                     anchors: torch.Tensor, img_size, *,
                                     nms_iou: float, n_post_nms: int,
                                     min_size: float):
    """Kernel 3's two launches in plain PyTorch: decode and mask, sort by
    ``order_keys`` (launch A), then kernel 1's steps over the sorted rows
    (launch B).  Equals ``fused_proposals_rows_reference`` bit for bit;
    shapes as there."""
    roi, masked = tp._decode_masked(rpn_locs, rpn_fg_scores, anchors,
                                    img_size, min_size)
    boxes, scores = tp.sorted_rows_reference(roi, masked)
    return tp.greedy_nms_rows_reference(boxes, scores, n_post=n_post_nms,
                                        iou_threshold=nms_iou)[:3]


def _inputs(rng, b, n, scores="ties"):
    """``n`` anchors of 10..70 px over a 128x160 image; rows 3k and 3k+1
    share an anchor and decode to a pair at IoU ~ 0.7; every 12th row
    shrunk under the min size.  ``scores``: ``"ties"`` (40 levels),
    ``"signed_zeros"`` (all but every 40th row -0.0 or +0.0),
    ``"masked_image"`` (ties, and image 0 has every row under the min
    size) or ``"few_valid"`` (ties, and all but 5 rows of image 1 under
    it)."""
    xy = rng.rand(n, 2) * np.array([IMG[1], IMG[0]]) * 0.95
    anchors = np.concatenate([xy, xy + rng.rand(n, 2) * 60 + 10], -1)
    anchors[1::3] = anchors[0::3][: len(anchors[1::3])]
    locs = rng.randn(b, n, 4) * 0.2
    locs[:, 0::3] = 0.0
    locs[:, 1::3] = 0.0
    m = locs[:, 1::3].shape[1]
    locs[:, 1::3, 0] = 0.3 / 1.7 * (1.0 + rng.uniform(-1e-5, 1e-5, (b, m)))
    locs[:, 2::12, 2:] = -4.0
    fg = rng.randint(0, 40, size=(b, n)) / 40.0
    if scores == "signed_zeros":
        zeros = np.where(rng.rand(b, n) < 0.5, -0.0, 0.0)
        fg = np.where(np.arange(n) % 40 == 0, fg, zeros)
    elif scores == "masked_image":
        locs[0, :, 2:] = -6.0
    elif scores == "few_valid":
        locs[1, 5:, 2:] = -6.0
    return (T(locs.astype(np.float32)), T(fg.astype(np.float32)),
            T(anchors.astype(np.float32)))


# ---------------------------------------------- kernel 3: order + walk
@pytest.mark.parametrize("n,n_post,scores", [
    (1, 1, "ties"), (64, 8, "ties"), (600, 48, "ties"), (600, 48, "signed_zeros"),
    (601, 64, "masked_image"), (300, 40, "few_valid"), (130, 200, "ties"),
    (900, 300, "signed_zeros")])
def test_sorted_walk_equals_plain_argmax_steps(rng, n, n_post, scores):
    """Sorting by the key, then kernel 1's steps, equals kernel 3's plain
    argmax steps bit for bit: on ties, on -0.0/+0.0 scores, on masked rows,
    on an image with every row masked, and with n_post above the number of
    valid rows."""
    locs, fg, anchors = _inputs(rng, 2, n, scores)
    kw = dict(KW, n_post_nms=n_post)
    want = tp.fused_proposals_rows_reference(locs, fg, anchors, IMG, **kw)
    got = fused_proposals_sorted_reference(locs, fg, anchors, IMG, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert torch.equal(torch.signbit(g), torch.signbit(w))
    kept = want[2].sum(1)
    if scores == "masked_image":
        assert kept[0] == 0 and kept[1] > 0
    if scores == "few_valid" or n_post > n:
        assert kept.min() < n_post
    if scores == "signed_zeros":
        out = want[1][want[2]]
        assert bool(((out == 0) & torch.signbit(out)).any())


@pytest.mark.parametrize("n,n_post", [(300, 48), (600, 96)])
def test_sorted_walk_equals_interpreted_batched_kernel(rng, n, n_post):
    """The same composition equals the JAX package's ``_batched_kernel``
    run interpreted, bit for bit.  The anchors are moved to whole pixels,
    the offsets to sixteenths and ``dw = dh = 0``, so that every step of
    both decodes is exact (however each side fuses its multiply-adds)."""
    locs, fg, anchors = _inputs(rng, 2, n)
    anchors = torch.round(anchors)
    locs[..., :2] = torch.round(locs[..., :2] * 16.0) / 16.0
    locs[:, 1::3, 0] = 3.0 / 16.0
    locs[..., 2:] = 0.0
    kw = dict(KW, n_post_nms=n_post)
    want = j_fused_batched(jnp.asarray(locs.numpy()), jnp.asarray(fg.numpy()),
                           jnp.asarray(anchors.numpy()), IMG, interpret=True,
                           **kw)
    got = fused_proposals_sorted_reference(locs, fg, anchors, IMG, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum(1).min() > 0


@pytest.mark.parametrize("kind", ["ties", "signed_zeros", "masked",
                                  "negative", "spread"])
def test_order_keys_equal_stable_descending_sort(rng, kind):
    """The key order equals ``torch.sort(stable=True, descending=True)`` of
    the scores with -0.0 made +0.0, and the keys are unique."""
    b, n = 3, 500
    if kind == "ties":
        s = rng.randint(0, 5, size=(b, n)) / 4.0
    elif kind == "signed_zeros":
        s = np.where(rng.rand(b, n) < 0.5, -0.0, 0.0)
        s[:, ::9] = rng.randint(-3, 3, size=s[:, ::9].shape)
    elif kind == "masked":
        s = rng.rand(b, n)
        s[:, ::3] = NEG_INF
    elif kind == "negative":
        s = -rng.randint(0, 50, size=(b, n)) * 1e7
    else:
        s = rng.randn(b, n) * 10.0 ** rng.randint(-30, 30, size=(b, n))
    s = T(s.astype(np.float32))
    keys = tp.order_keys(s)
    assert keys.dtype == torch.int64
    assert all(len(set(k.tolist())) == n for k in keys)
    canon = torch.where(s == 0, torch.zeros_like(s), s)
    want = torch.sort(canon, dim=1, descending=True, stable=True).indices
    assert torch.equal(torch.argsort(keys, dim=1), want)
    boxes = torch.arange(b * n * 4, dtype=torch.float32).reshape(b, n, 4)
    sb, ss = tp.sorted_rows_reference(boxes, s)
    assert torch.equal(ss, torch.gather(s, 1, want))
    assert torch.equal(sb, torch.gather(boxes, 1, want[..., None].expand(-1, -1, 4)))


# -------------------------------------- kernel 1: the cluster's bounds
@pytest.mark.parametrize("k,least", [(16368, 2), (65472, 5), (71999, 6),
                                     (12996, 1), (tp.MAX_KERNEL_ROWS, 8)])
def test_nms_cluster_floor(k, least):
    """The fewest blocks whose shared memory holds an image's rows: 16
    bytes of box a row and 8 bytes of alive bits a tile, within the
    232,448 bytes a block may opt into, less the kernel's static shared
    memory; and one block fewer would not hold them."""
    lo, hi = tp.nms_cluster_bounds(k)
    assert lo == least and hi == 8
    tiles = -(-k // tp.NMS_TILE)
    per_block = -(-tiles // lo)
    assert per_block * tp.NMS_TILE_BYTES + tp.NMS_STATIC_SMEM <= 232448
    if lo > 1:
        assert -(-tiles // (lo - 1)) > tp.NMS_MAX_TILES_PER_BLOCK


@pytest.mark.parametrize("k", [tp.MAX_KERNEL_ROWS + 1, 200000])
def test_nms_cluster_bounds_raise_above_the_cap(k):
    """The bounds are per launch: one launch of kernel 1's walk holds up
    to ``MAX_KERNEL_ROWS`` rows an image (every table the whole-table train
    route reaches at the default ``n_train_pre_nms``, N < 72,000, is one
    launch), and the bounds raise above it, with the cap in the message.
    Kernels 1 and 3 take larger tables in chunks of at most that many rows
    (``nms_chunks``, ``tests/test_torch_nms_chunks.py``)."""
    assert tp.MAX_KERNEL_ROWS >= 71999
    with pytest.raises(ValueError, match=f"1..{tp.MAX_KERNEL_ROWS} rows"):
        tp.nms_cluster_bounds(k)


# ---------------------------------------------- kernel 5: slice plan
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", [4, 12, 260, 512])
@pytest.mark.parametrize("b,r", [(16, 300), (16, 128), (1, 300)])
def test_roi_pool_plan_slices(b, r, c, elem):
    """At 38x38, every C the wrapper takes gets the slice route: vectors of
    16 bytes where a pixel's bytes allow (8 otherwise) that tile the pixel
    exactly, slices that cover every vector once and, with the chunk's bin
    edges, fit in a block's shared memory, and roi chunks that cover every
    roi."""
    plan = roi_pool_plan(b, 38, 38, c, r, elem)
    assert plan["route"] == "slice"
    vec = plan["vec_bytes"]
    assert vec == (16 if c * elem % 16 == 0 else 8) and c * elem % vec == 0
    cv = c * elem // vec
    nv, n_slices = plan["nv"], plan["n_slices"]
    assert (n_slices - 1) * nv < cv <= n_slices * nv
    assert 38 * 38 * nv * vec <= SLICE_SMEM_BYTES - EDGE_BYTES
    per_chunk = -(-r // plan["n_chunks"])
    assert (plan["n_chunks"] - 1) * per_chunk < r <= plan["n_chunks"] * per_chunk
    assert plan["smem_bytes"] == 38 * 38 * nv * vec + (per_chunk * 14 + 49) * 4
    assert plan["smem_bytes"] <= SLICE_SMEM_BYTES < 232448
    if (b, c) == (16, 512):
        # the RoI head's map: 64 bf16 or 32 f32 channels a slice, 184,832
        # bytes, and one chunk (128 or 256 blocks)
        assert nv * vec // elem == (64 if elem == 2 else 32)
        assert 38 * 38 * nv * vec == 184832 and plan["n_chunks"] == 1


@pytest.mark.parametrize("h,w,c,elem,route", [
    (130, 120, 8, 2, "direct"), (130, 120, 4, 4, "direct"),
    (128, 101, 8, 2, "slice"), (128, 102, 8, 2, "direct"),
    (130, 120, 4, 2, "slice"), (256, 256, 4, 2, "direct")])
def test_roi_pool_plan_direct_for_maps_too_big(h, w, c, elem, route):
    """Where even one 16-byte vector a pixel does not fit beside the bin
    edges (H x W above 12,928 pixels), the wrapper takes the direct scan;
    8-byte vectors (bf16, C % 8 = 4) fit twice the pixels, up to the 16-bit
    pixel indices of the slice route."""
    assert roi_pool_plan(1, h, w, c, 10, elem)["route"] == route


def test_roi_pool_plan_chunks_many_rois():
    """More rois than one chunk's bin edges hold go to more chunks."""
    plan = roi_pool_plan(16, 38, 38, 512, 2000, 2)
    per_chunk = -(-2000 // plan["n_chunks"])
    assert plan["n_chunks"] > 1 and per_chunk * 8 * 7 + 4 * 49 <= EDGE_BYTES
