"""PyTorch port: kernel 1's walk in chunks, and its plain route as the
detector's class-offset NMS, on the CPU.

Kernel 1 (``csrc/nms.cu``) holds at most ``MAX_KERNEL_ROWS`` (112,128) rows
an image in one launch's shared memory.  Above that ``ops/proposals.py``
walks the score-sorted rows in chunks (``nms_chunks``), one launch each:
a launch first clears its rows against every box the earlier chunks kept,
then walks its own rows into the slots still free.  Kernel 3's launch B is
the same walk.  Here the plain chunked walk
(:func:`greedy_nms_chunked_reference`, chunk size as a parameter) is held
bit for bit against the plain one-pass steps and against the JAX package's
``_batched_nms_kernel`` run interpreted; then the chunk planner.  The
kernel itself runs only on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).

The detector's post-process runs its class-offset NMS as one call of
kernel 1 with the kept rows' index (``nets/detector.py:class_offset_nms``);
its plain route is held index for index against the JAX package's
``ops/nms.py:nms``, image by image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.ops.nms import nms as j_nms
from two_stage_object_detection_tpu.ops.pallas_proposals import (
    _truncated_nms_call)
from two_stage_object_detection_tpu_torch.nets.detector import (
    class_offset_nms)
from two_stage_object_detection_tpu_torch.ops import proposals as tp
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF
from torch_nms_cases import offset_candidates

T = torch.from_numpy
THR = 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def greedy_nms_chunked_reference(boxes: torch.Tensor, scores: torch.Tensor,
                                 *, n_post: int, iou_threshold: float,
                                 chunk: int):
    """Kernel 1's chunked walk in plain PyTorch, with the chunk size as a
    parameter; the tests hold it against ``greedy_nms_rows_reference``.

    The sorted rows go ``chunk`` at a time.  Each chunk's rows are first
    cleared against every box earlier chunks kept (their IoU taken with the
    kept box as the selected one, as a step takes it), then walked with
    ``greedy_nms_rows_reference``'s steps into the slots still free.
    A row is kept exactly when no earlier kept row overlaps it by more than
    the threshold, so the result is the same bit for bit.  Shapes as there,
    each kept row's index counted from the table's first row.
    """
    b, k, _ = boxes.shape
    dev = boxes.device
    rows = torch.arange(b, device=dev)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    out_boxes = torch.zeros((b, n_post, 4), dtype=boxes.dtype, device=dev)
    out_scores = torch.zeros((b, n_post), dtype=scores.dtype, device=dev)
    out_valid = torch.zeros((b, n_post), dtype=torch.bool, device=dev)
    out_index = torch.zeros((b, n_post), dtype=torch.int32, device=dev)
    n_kept = torch.zeros(b, dtype=torch.int64, device=dev)

    def iou_above(sel, x1, y1, x2, y2, area):
        ix1 = torch.maximum(x1, sel[:, 0:1])
        iy1 = torch.maximum(y1, sel[:, 1:2])
        ix2 = torch.minimum(x2, sel[:, 2:3])
        iy2 = torch.minimum(y2, sel[:, 3:4])
        inter = (torch.clamp(ix2 - ix1, min=0.0)
                 * torch.clamp(iy2 - iy1, min=0.0))
        sel_area = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
        return inter / (area + sel_area[:, None] - inter + 1e-8) > thr

    for c0 in range(0, k, chunk):
        cb = boxes[:, c0:c0 + chunk]
        x1, y1, x2, y2 = cb.unbind(-1)
        area = (x2 - x1) * (y2 - y1)
        s_alive = scores[:, c0:c0 + chunk].clone()
        for m in range(int(n_kept.max())):
            sup = iou_above(out_boxes[:, m], x1, y1, x2, y2, area)
            s_alive = torch.where(sup & (n_kept > m)[:, None], NEG_INF, s_alive)
        while bool((n_kept < n_post).any()):
            i = torch.argmax(s_alive, dim=1)
            sc = s_alive[rows, i]
            take = (sc > NEG_INF / 2) & (n_kept < n_post)
            if not bool(take.any()):
                break
            sel = cb[rows, i]
            sup = iou_above(sel, x1, y1, x2, y2, area)
            sup[rows, i] = True
            s_alive = torch.where(sup & take[:, None], NEG_INF, s_alive)
            slot = n_kept.clamp(max=n_post - 1)
            t = take[:, None]
            out_boxes[rows, slot] = torch.where(t, sel, out_boxes[rows, slot])
            out_scores[rows, slot] = torch.where(take, sc,
                                                 out_scores[rows, slot])
            out_valid[rows, slot] |= take
            out_index[rows, slot] = torch.where(
                take, (c0 + i).to(torch.int32), out_index[rows, slot])
            n_kept += take.to(torch.int64)
    return out_boxes, out_scores, out_valid, out_index


def _rows(rng, b, k, case, n_dup=0):
    """Score-sorted rows (stable, ties by lower index), the last tenth
    masked.  ``case``: ``"first_chunk"`` (distinct boxes, coarse scores: the
    first chunk alone fills a small ``n_post``); ``"crossing"`` (the
    ``n_dup`` best rows are 1 px jitters of 6 boxes, so the first chunk
    keeps at most 6 and the later rows fill the rest); ``"signed_zeros"``
    (all scores but every 7th -0.0 or +0.0, which the plain argmax holds
    equal)."""
    xy = rng.rand(b, k, 2) * 200.0
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 60.0 + 4.0], -1)
    scores = rng.randint(0, 30, size=(b, k)) / 30.0
    if case == "crossing":
        base = rng.rand(b, 6, 2) * 200.0
        pick = np.take_along_axis(base, rng.randint(0, 6, (b, n_dup))[..., None], 1)
        boxes[:, :n_dup] = (np.concatenate([pick, pick + 60.0], -1)
                            + rng.rand(b, n_dup, 4))
        scores[:, :n_dup] = 0.5 + rng.rand(b, n_dup) * 0.5
        scores[:, n_dup:] = rng.rand(b, k - n_dup) * 0.5
    elif case == "signed_zeros":
        scores = np.where(rng.rand(b, k) < 0.5, -0.0, 0.0)
        scores[:, ::7] = rng.randint(0, 3, size=scores[:, ::7].shape) / 3.0
    scores[:, k - k // 10:] = -1e9
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1).astype(np.float32),
            np.take_along_axis(scores, order, 1).astype(np.float32))


def _case(rng, chunk, case):
    """(boxes, scores, n_post) of ``case`` over three and a bit chunks."""
    k = 3 * chunk + 37
    n_post = {"first_chunk": 10, "crossing": k // 4, "signed_zeros": k // 3}[case]
    boxes, scores = _rows(rng, 2, k, case, n_dup=chunk + chunk // 2)
    return boxes, scores, n_post


def _first_chunk_kept(boxes, scores, chunk, n_post):
    return tp.greedy_nms_rows_reference(
        T(boxes[:, :chunk]), T(scores[:, :chunk]), n_post=n_post,
        iou_threshold=THR)[2].sum(1)


@pytest.mark.parametrize("case", ["first_chunk", "crossing", "signed_zeros"])
@pytest.mark.parametrize("chunk", [64, 100, 1000])
def test_chunked_walk_equals_plain_steps(rng, chunk, case):
    """Chunk by chunk equals the one-pass steps bit for bit (sign of zero
    included): where ``n_post`` is filled inside the first chunk, where the
    kept set crosses chunk boundaries (the first chunk keeps fewer than
    ``n_post``, the later ones clear their rows against its boxes), and on
    -0.0/+0.0 ties."""
    boxes, scores, n_post = _case(rng, chunk, case)
    got = greedy_nms_chunked_reference(T(boxes), T(scores), n_post=n_post,
                                          iou_threshold=THR, chunk=chunk)
    want = tp.greedy_nms_rows_reference(T(boxes), T(scores), n_post=n_post,
                                        iou_threshold=THR)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert torch.equal(torch.signbit(g.float()), torch.signbit(w.float()))
    first = _first_chunk_kept(boxes, scores, chunk, n_post)
    kept = want[2].sum(1)
    if case == "first_chunk":
        assert bool((first == n_post).all())
    elif case == "crossing":
        assert bool((first <= 6).all()) and bool((kept > first).all())
        assert bool((kept == n_post).all())
    else:
        out = want[1][want[2]]
        assert bool(((out == 0) & torch.signbit(out)).any())


@pytest.mark.parametrize("case", ["first_chunk", "crossing", "signed_zeros"])
@pytest.mark.parametrize("chunk", [64, 100, 1000])
def test_chunked_walk_equals_interpreted_pallas_kernel(rng, chunk, case):
    """The chunked walk equals the JAX package's ``_batched_nms_kernel``
    run interpreted: equal valid masks, scores (-0.0 equal to +0.0, as the
    kernel's one-hot sums give) and boxes."""
    boxes, scores, n_post = _case(rng, chunk, case)
    jb, js, jv = _truncated_nms_call(jnp.asarray(boxes), jnp.asarray(scores),
                                     nms_iou=THR, n_post_nms=n_post,
                                     interpret=True)
    tb, ts, tv, _ = greedy_nms_chunked_reference(
        T(boxes), T(scores), n_post=n_post, iou_threshold=THR, chunk=chunk)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tv.sum()) > 0


@pytest.mark.parametrize("k,n_chunks", [(tp.MAX_KERNEL_ROWS, 1),
                                        (tp.MAX_KERNEL_ROWS + 1, 2),
                                        (250000, 3)])
def test_nms_chunks_plan(k, n_chunks):
    """The fewest launches that each hold at most ``MAX_KERNEL_ROWS`` rows:
    consecutive, covering every row once, of equal size in whole 64-row
    tiles but the last, each within kernel 1's per-launch cluster bounds."""
    chunks = tp.nms_chunks(k)
    assert len(chunks) == n_chunks == -(-k // tp.MAX_KERNEL_ROWS)
    assert chunks[0][0] == 0
    for (c0, rows), nxt in zip(chunks, chunks[1:] + [(k, 0)]):
        assert 0 < rows <= tp.MAX_KERNEL_ROWS and c0 + rows == nxt[0]
        least, most = tp.nms_cluster_bounds(rows)
        assert 1 <= least <= most <= tp.NMS_MAX_CLUSTER
    sizes = [rows for _, rows in chunks]
    assert all(s == sizes[0] and s % tp.NMS_TILE == 0 for s in sizes[:-1])
    assert sizes[-1] <= sizes[0]


@pytest.mark.parametrize("case", ["first_chunk", "crossing", "signed_zeros"])
@pytest.mark.parametrize("chunk", [64, 100, 1000])
def test_chunked_walk_index_equals_plain_steps(rng, chunk, case):
    """The chunked walk's row index of each kept box, counted from the
    table's first row across chunks, equals the one-pass steps' index, 0 in
    the slots not kept; the index gathers the kept boxes."""
    boxes, scores, n_post = _case(rng, chunk, case)
    got = greedy_nms_chunked_reference(T(boxes), T(scores), n_post=n_post,
                                          iou_threshold=THR, chunk=chunk)
    want = tp.greedy_nms_rows_reference(T(boxes), T(scores), n_post=n_post,
                                        iou_threshold=THR)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    index, valid = want[3], want[2]
    assert index.dtype == torch.int32
    assert bool((index[~valid] == 0).all())
    rows = torch.gather(T(boxes), 1, index.long()[..., None].expand(-1, -1, 4))
    assert torch.equal(rows[valid], want[0][valid])
    if case == "crossing":
        assert int(index.max()) >= chunk       # kept rows past the first chunk


# ------------------------------------- the post-process's class-offset NMS
@pytest.mark.parametrize("n_post", [100, 7])
@pytest.mark.parametrize("case,b,r,n_class,thr", [
    ("tied_scores", 3, 50, 8, 0.1),
    ("same_box_two_classes", 2, 40, 10, 0.1),
    ("under_thresh", 3, 60, 20, 0.1),
    ("no_valid_image", 3, 30, 5, 0.3),
    ("few_survivors", 2, 100, 20, 0.1),
    ("suppress_most", 2, 200, 2, 0.05),
])
def test_class_offset_nms_plain_route_equals_nms_loop(rng, case, b, r, n_class,
                                                      thr, n_post):
    """The post-process's class-offset NMS on its plain route (kernel 1's
    plain version with the index) keeps the same candidates as the JAX
    package's ``ops/nms.py:nms`` over the offset boxes, image by image,
    index for index and mask for mask: on tied scores, one box under two
    classes (which the offset keeps apart), rows under the score
    threshold, an image with no valid candidate, fewer survivors than
    ``n_post``, and a crowd in which the threshold suppresses most rows."""
    cand_boxes, cand_scores, cand_labels = offset_candidates(
        rng, b, r, n_class, case, size=64)
    img_size = (64, 64)
    idx, keep = class_offset_nms(cand_boxes, cand_scores, cand_labels,
                                 img_size, iou_threshold=thr,
                                 max_detections=n_post, use_kernel=False)
    offset = cand_labels.to(torch.float32) * (64.0 + 2.0)
    boxes = (cand_boxes + offset[..., None]).numpy()
    assert idx.dtype == torch.int64
    for i in range(b):
        want_idx, want_keep = j_nms(
            jnp.asarray(boxes[i]), jnp.asarray(cand_scores[i].numpy()), thr,
            n_post, valid=jnp.asarray((cand_scores[i] > 0).numpy()))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(want_keep))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))

    n_valid = (cand_scores > 0).sum(1)
    kept = keep.sum(1)
    assert bool((kept <= torch.clamp(n_valid, max=n_post)).all())
    if case == "tied_scores":
        s = cand_scores[0][cand_scores[0] > 0]
        assert len(torch.unique(s)) < len(s)
    elif case == "same_box_two_classes" and n_post == 100:
        got = torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4))
        k0 = got[0][keep[0]]
        assert len(torch.unique(k0, dim=0)) < len(k0)   # one box, two labels
    elif case == "under_thresh":
        assert bool((n_valid < cand_scores.shape[1]).all())
    elif case == "no_valid_image":
        assert int(kept[1]) == 0 and int(kept[0]) > 0
        assert bool((idx[1] == 0).all())
    elif case == "few_survivors" and n_post == 100:
        assert bool((kept < n_post).all()) and bool((kept > 0).all())
    elif case == "suppress_most":
        assert bool((kept <= n_class).all()) and bool((n_valid > 50).all())
