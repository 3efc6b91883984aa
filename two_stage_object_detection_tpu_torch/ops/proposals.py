"""Batched RPN proposal generation with the hand-written kernels.

The counterpart of the JAX package's ``ops/pallas_proposals.py``, with its
two routes (:func:`proposals_batched` picks one as
``fused_proposals_batched`` does):

* **truncated** (``6 * n_pre_nms <= N``, the FPN predict and train shapes:
  3000 -> 300 and 12000 -> 600 of 90,090 anchors):
  decode, clip and min-size masking run over the whole anchor table in
  plain PyTorch, an exact top-``n_pre_nms`` cut (a stable sort: ties go to
  the lower index, as ``lax.top_k`` sends them) keeps the ``K`` best, and
  the greedy NMS over the ``[B, K]`` survivors runs in kernel 1
  (``csrc/nms.cu``, :func:`greedy_nms`);
* **whole table** (otherwise, the single-scale path and small FPN inputs):
  kernel 3 (:func:`fused_proposals_batched`) in two launches.  Launch A
  (``csrc/proposals.cu``) decodes, clips and min-size masks all ``N``
  anchors and sorts each image's rows by a unique 64-bit key (score
  descending, index ascending: :func:`order_keys`), in shared memory and
  with no library sort; launch B is kernel 1's walk over the sorted rows
  with ``K = N`` (:func:`_nms_walk`, which ``launch.greedy_nms`` does not
  count).  Taking "the best alive score, lowest index on ties" at each
  step, as the JAX kernel does, is walking the rows in that order.  Its
  per-image form, kernel 4 (:func:`fused_proposals`), is the same launches
  with ``B = 1``; like the JAX package's ``_fused_kernel`` it is on neither
  the predict nor the train path.

Kernel 1 also ends ``FasterRCNN.detect``: the class-offset NMS over its
``4 * max_detections`` score-sorted candidates.  Every launch stores the
index of each kept row, by which the post-process gathers labels and boxes;
the proposal routes drop it.

On the card both go through ``torch.library`` custom ops,
``tsod::greedy_nms`` (:func:`greedy_nms_op`) and ``tsod::fused_proposals``
(:func:`fused_proposals_op`), whose fake implementations give the output
shapes: ``torch.export`` keeps the launches in its graph instead of tracing
into ``ctypes``.  The real implementations launch and count each call in
``utils.profiling.counters`` (``launch.greedy_nms``,
``launch.fused_proposals_batched``; kernel 4's ``launch.fused_proposals``).

Both kernels take any number of rows an image.  Kernel 1's walk holds up to
``MAX_KERNEL_ROWS`` (112,128) rows a launch in shared memory; above that it
walks the sorted rows in chunks (:func:`nms_chunks`), one launch each, every
launch first clearing its rows against the boxes earlier chunks kept.
"""

from __future__ import annotations

import functools

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, loc2bbox)
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF, topk_stable

# kernel 1 spreads an image over a cluster of up to NMS_MAX_CLUSTER blocks,
# each holding its share of the rows in tiles of NMS_TILE: 16 bytes of box a
# row and 8 bytes of alive bits a tile, in dynamic shared memory.  A block
# may opt into 232,448 bytes on the H100; NMS_STATIC_SMEM bounds what the
# kernel keeps in static shared memory (4,884 bytes).  So a block holds at
# most NMS_MAX_TILES_PER_BLOCK tiles (219), an image of K rows needs at
# least ceil(K / 64 / 219) blocks, and 8 blocks hold MAX_KERNEL_ROWS rows
# (112,128): the most one launch walks.  More rows go in chunks.
NMS_TILE = 64
NMS_MAX_CLUSTER = 8
BLOCK_SMEM_BYTES = 232448
NMS_STATIC_SMEM = 6144
NMS_TILE_BYTES = NMS_TILE * 16 + 8
NMS_MAX_TILES_PER_BLOCK = (BLOCK_SMEM_BYTES - NMS_STATIC_SMEM) // NMS_TILE_BYTES
MAX_KERNEL_ROWS = NMS_MAX_CLUSTER * NMS_MAX_TILES_PER_BLOCK * NMS_TILE

def greedy_nms_rows_reference(boxes: torch.Tensor, scores: torch.Tensor, *,
                              n_post: int, iou_threshold: float):
    """Plain PyTorch version of kernel 1 (the JAX ``_greedy_nms_rows`` loop).

    ``n_post`` select-and-suppress steps over ``boxes [B, K, 4]`` /
    ``scores [B, K]``: each step takes the best still-alive score (first
    index on ties), emits it (valid where ``score > NEG_INF/2``), and kills
    every box with ``iou > thr`` and itself.  Returns ``(boxes [B, n_post,
    4], scores [B, n_post], valid [B, n_post], index [B, n_post])``, the
    index int32, the row each step took; invalid slots zeroed.
    """
    b, _, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    s_alive = scores.clone()
    out_boxes = torch.zeros((b, n_post, 4), dtype=boxes.dtype, device=boxes.device)
    out_scores = torch.zeros((b, n_post), dtype=scores.dtype, device=boxes.device)
    out_valid = torch.zeros((b, n_post), dtype=torch.bool, device=boxes.device)
    out_index = torch.zeros((b, n_post), dtype=torch.int32, device=boxes.device)
    for k in range(n_post):
        i = torch.argmax(s_alive, dim=1)
        sc = s_alive[rows, i]
        valid = sc > NEG_INF / 2
        sel = boxes[rows, i]                                   # [B, 4]
        ix1 = torch.maximum(x1, sel[:, 0:1])
        iy1 = torch.maximum(y1, sel[:, 1:2])
        ix2 = torch.minimum(x2, sel[:, 2:3])
        iy2 = torch.minimum(y2, sel[:, 3:4])
        inter = (torch.clamp(ix2 - ix1, min=0.0)
                 * torch.clamp(iy2 - iy1, min=0.0))
        iou = inter / (area + area[rows, i][:, None] - inter + 1e-8)
        suppress = iou > thr
        suppress[rows, i] = True
        s_alive = torch.where(suppress, NEG_INF, s_alive)
        vf = valid.to(boxes.dtype)
        out_boxes[:, k] = sel * vf[:, None]
        out_scores[:, k] = sc * vf
        out_valid[:, k] = valid
        out_index[:, k] = torch.where(valid, i, 0)
    return out_boxes, out_scores, out_valid, out_index


def nms_chunks(k: int) -> list[tuple[int, int]]:
    """Kernel 1's launches over ``k`` sorted rows an image, as ``(first
    row, rows)``: one launch up to ``MAX_KERNEL_ROWS`` rows, else the fewest
    chunks that each hold at most that many, of equal size in whole tiles
    (the last one the rest)."""
    if k < 1:
        raise ValueError(f"greedy_nms kernel takes at least 1 row, got {k}")
    n = -(-k // MAX_KERNEL_ROWS)
    tiles = -(-k // (n * NMS_TILE))          # tiles a chunk, rounded up
    size = tiles * NMS_TILE
    return [(c0, min(size, k - c0)) for c0 in range(0, k, size)]


def nms_cluster_bounds(k: int) -> tuple[int, int]:
    """Blocks of kernel 1's cluster for a launch over ``k`` rows per image,
    ``(least, most)``: the fewest whose shared memory holds the rows, and
    one per tile of ``NMS_TILE`` rows up to ``NMS_MAX_CLUSTER``.  Raises
    outside ``1..MAX_KERNEL_ROWS``, the rows one launch holds
    (:func:`nms_chunks` cuts larger tables)."""
    if not 0 < k <= MAX_KERNEL_ROWS:
        raise ValueError(f"greedy_nms kernel takes 1..{MAX_KERNEL_ROWS} rows "
                         f"per image, got {k}")
    tiles = -(-k // NMS_TILE)
    return -(-tiles // NMS_MAX_TILES_PER_BLOCK), min(NMS_MAX_CLUSTER, tiles)


def nms_cluster_size(k: int) -> int:
    """The most blocks kernel 1 spreads an image of ``k`` rows over."""
    return nms_cluster_bounds(k)[1]


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, *, n_post: int,
               iou_threshold: float, use_kernel: bool = True):
    """Kernel 1: greedy NMS over score-sorted ``boxes [B, K, 4]`` f32.

    The rows must be sorted by score, descending, ties by lower index (what
    :func:`~..ops.nms.topk_stable` gives).  On a CUDA tensor with
    ``use_kernel`` this calls the custom op ``tsod::greedy_nms``
    (:func:`greedy_nms_op`), which launches ``csrc/nms.cu`` (or raises):
    once for up to ``MAX_KERNEL_ROWS`` rows, once a chunk of
    :func:`nms_chunks` above that.  On the CPU, or with
    ``use_kernel=False``, it runs :func:`greedy_nms_rows_reference`.  Same
    outputs either way, bit for bit: ``(boxes, scores, valid, index)``.
    """
    if not (use_kernel and boxes.is_cuda):
        return greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                         iou_threshold=iou_threshold)
    return greedy_nms_op(boxes, scores, n_post, float(iou_threshold))


@torch.library.custom_op("tsod::greedy_nms", mutates_args=(),
                         device_types="cuda")
def greedy_nms_op(boxes: torch.Tensor, scores: torch.Tensor, n_post: int,
                  iou_threshold: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Kernel 1 as a custom op, so that ``torch.export`` keeps the launch
    in its graph; counted in ``launch.greedy_nms``.  Arguments and
    outputs as :func:`greedy_nms_rows_reference`."""
    b, k, _ = boxes.shape
    boxes, scores = boxes.contiguous(), scores.contiguous()
    _cuda.require(boxes, "boxes", torch.float32, (b, k, 4))
    _cuda.require(scores, "scores", torch.float32, (b, k))
    return _nms_walk(boxes, scores, n_post, iou_threshold,
                     count="launch.greedy_nms")


@greedy_nms_op.register_fake
def _(boxes, scores, n_post, iou_threshold):
    return (*_nms_outputs(boxes, n_post),
            boxes.new_empty((boxes.shape[0], n_post), dtype=torch.int32))


def _nms_outputs(like: torch.Tensor, n_post: int):
    """Kernel 1's empty outputs for ``like``'s batch: boxes, scores, valid."""
    b = like.shape[0]
    return (like.new_empty((b, n_post, 4), dtype=torch.float32),
            like.new_empty((b, n_post), dtype=torch.float32),
            like.new_empty((b, n_post), dtype=torch.bool))


def _nms_walk(boxes, scores, n_post, iou_threshold, count=None):
    """Launch kernel 1 (``csrc/nms.cu``) on checked ``[B, K]`` rows, once a
    chunk of :func:`nms_chunks`, the first launch counted in ``count``
    (:func:`greedy_nms` counts its calls, kernel 3 its own).  Between
    chunks the count each image kept stays on the device.  Returns boxes,
    scores, valid and the index of each kept row."""
    b, k, _ = boxes.shape
    dev = boxes.device
    chunks = nms_chunks(k)
    out_boxes = torch.empty((b, n_post, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, n_post), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, n_post), dtype=torch.bool, device=dev)
    out_index = torch.empty((b, n_post), dtype=torch.int32, device=dev)
    kept = (torch.zeros((b,), dtype=torch.int32, device=dev)
            if len(chunks) > 1 else None)
    for c0, rows in chunks:
        _cuda.launch("nms_launch", dev, boxes.data_ptr() + c0 * 16,
                     scores.data_ptr() + c0 * 4, b, rows, k, n_post,
                     iou_threshold, _nms_cluster(dev.index, b, rows),
                     out_boxes.data_ptr(), out_scores.data_ptr(),
                     out_valid.data_ptr(), out_index.data_ptr(), c0,
                     None if kept is None else kept.data_ptr(),
                     count=None if c0 else count)
    return out_boxes, out_scores, out_valid, out_index


@functools.lru_cache(maxsize=None)
def _nms_cluster(device_index: int, b: int, k: int) -> int:
    """Blocks per image that let all ``b`` images run at once on this card,
    within :func:`nms_cluster_bounds` (``csrc/nms.cu:nms_pick_cluster``)."""
    least, most = nms_cluster_bounds(k)
    with torch.cuda.device(device_index):
        return _cuda.entry("nms_pick_cluster")(b, k, most, least)


def _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size, min_size):
    """Decode + clip, and scores with rows under ``min_size`` set to NEG."""
    roi = clip_boxes(loc2bbox(anchors, rpn_locs.float()), img_size)
    wh = roi[..., 2:4] - roi[..., 0:2]
    ok = (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)
    return roi, torch.where(ok, rpn_fg_scores.float(), NEG_INF)


def fused_proposals_rows_reference(rpn_locs: torch.Tensor,
                                   rpn_fg_scores: torch.Tensor,
                                   anchors: torch.Tensor, img_size, *,
                                   nms_iou: float, n_post_nms: int,
                                   min_size: float):
    """Plain PyTorch version of kernels 3 and 4 (the JAX ``_batched_kernel``).

    Decodes every row as the kernel does (``cx = dx*aw + acx``,
    ``w = exp(dw)*aw``, clip to ``[0, W]`` / ``[0, H]``, scores of rows with
    a side under ``min_size`` set to NEG), then runs ``n_post_nms``
    argmax/suppress steps over all ``N`` rows: the steps of
    :func:`greedy_nms_rows_reference`, without a sort.

    ``rpn_locs [B, N, 4]``, ``rpn_fg_scores [B, N]``, ``anchors [N, 4]`` ->
    ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    roi, masked = _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size,
                                 min_size)
    return greedy_nms_rows_reference(roi, masked, n_post=n_post_nms,
                                     iou_threshold=nms_iou)[:3]


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of launch A's sort key, ``[B, N]`` f32 ->
    ``[B, N]`` int64, unique per image, ascending in the greedy order:
    score descending (-0.0 taken as +0.0, as ``argmax`` takes them), then
    the row index ascending.  The kernel builds the unsigned 64-bit key
    ``~orderable(score) << 32 | row``; this is that key less 2^63, which
    orders the same in int64."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores.float())
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))
    row = torch.arange(s.shape[-1], dtype=torch.int64, device=s.device)
    return (0xFFFFFFFF - ordered - (1 << 31)) * (1 << 32) + row


def sorted_rows_reference(boxes: torch.Tensor, scores: torch.Tensor):
    """Plain PyTorch version of launch A's output: ``boxes [B, N, 4]`` and
    ``scores [B, N]`` in ascending :func:`order_keys` order (the keys are
    unique, so the order is unique)."""
    idx = torch.argsort(order_keys(scores), dim=-1)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(scores, 1, idx))


def fused_proposals_batched(rpn_locs: torch.Tensor,
                            rpn_fg_scores: torch.Tensor, anchors: torch.Tensor,
                            img_size, *, nms_iou: float, n_post_nms: int,
                            min_size: float, use_kernel: bool = True):
    """Kernel 3: whole-table decode + clip + min-size mask + greedy NMS.

    Shapes as :func:`fused_proposals_rows_reference`.  On a CUDA tensor
    with ``use_kernel`` this launches ``csrc/proposals.cu`` and then
    ``csrc/nms.cu`` (or raises): kernel 1's walk once for up to
    ``MAX_KERNEL_ROWS`` anchors, once a chunk of :func:`nms_chunks` above
    that.  On the CPU, or with ``use_kernel=False``, it runs the plain
    version.  Same outputs either way, bit for bit.
    """
    if not (use_kernel and rpn_locs.is_cuda):
        return fused_proposals_rows_reference(
            rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou=nms_iou,
            n_post_nms=n_post_nms, min_size=min_size)
    img_h, img_w = img_size
    return fused_proposals_op(rpn_locs, rpn_fg_scores, anchors, float(img_h),
                              float(img_w), float(nms_iou), n_post_nms,
                              float(min_size))


@torch.library.custom_op("tsod::fused_proposals", mutates_args=(),
                         device_types="cuda")
def fused_proposals_op(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                       anchors: torch.Tensor, img_h: float, img_w: float,
                       nms_iou: float, n_post_nms: int, min_size: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 3 (launch A, then kernel 1's walk) as a custom op, counted in
    ``launch.fused_proposals_batched``.  Arguments and outputs as
    :func:`fused_proposals_rows_reference`, the image size as two floats."""
    return _fused_launch(rpn_locs, rpn_fg_scores, anchors, (img_h, img_w),
                         nms_iou, n_post_nms, min_size,
                         "launch.fused_proposals_batched")


@fused_proposals_op.register_fake
def _(rpn_locs, rpn_fg_scores, anchors, img_h, img_w, nms_iou, n_post_nms,
      min_size):
    return _nms_outputs(rpn_locs, n_post_nms)


def fused_proposals(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                    anchors: torch.Tensor, img_size, *, nms_iou: float,
                    n_post_nms: int, min_size: float, use_kernel: bool = True):
    """Kernel 4: :func:`fused_proposals_batched` for one image, the same
    launches with ``B = 1``, counted in ``launch.fused_proposals``.

    ``rpn_locs [N, 4]``, ``rpn_fg_scores [N]``, ``anchors [N, 4]`` ->
    ``(rois [n_post, 4], scores [n_post], valid [n_post])``.
    """
    locs, fg = rpn_locs[None], rpn_fg_scores[None]
    if not (use_kernel and rpn_locs.is_cuda):
        out = fused_proposals_rows_reference(
            locs, fg, anchors, img_size, nms_iou=nms_iou,
            n_post_nms=n_post_nms, min_size=min_size)
    else:
        out = _fused_launch(locs, fg, anchors, img_size, nms_iou, n_post_nms,
                            min_size, "launch.fused_proposals")
    return tuple(t[0] for t in out)


def _fused_launch(rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou,
                  n_post, min_size, count):
    """Launch A (decode, mask, sort; ``csrc/proposals.cu``), counted in
    ``count``, and launch B (kernel 1's walk, ``csrc/nms.cu``, in chunks
    above ``MAX_KERNEL_ROWS``) over ``[B, N]`` anchors."""
    b, n, _ = rpn_locs.shape
    if n < 1:
        raise ValueError(f"the fused proposal kernel takes at least 1 anchor "
                         f"per image, got {n}")
    locs = rpn_locs.float().contiguous()
    scores = rpn_fg_scores.float().contiguous()
    anchors = anchors.float().contiguous()
    _cuda.require(locs, "rpn_locs", torch.float32, (b, n, 4))
    _cuda.require(scores, "rpn_fg_scores", torch.float32, (b, n))
    _cuda.require(anchors, "anchors", torch.float32, (n, 4))
    dev = locs.device
    keys = torch.empty((b, n), dtype=torch.int64, device=dev)
    sorted_boxes = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    sorted_scores = torch.empty((b, n), dtype=torch.float32, device=dev)
    img_h, img_w = img_size
    _cuda.launch("proposals_sort_launch", dev, locs.data_ptr(),
                 scores.data_ptr(), anchors.data_ptr(), b, n, min_size,
                 float(img_h), float(img_w), keys.data_ptr(),
                 sorted_boxes.data_ptr(), sorted_scores.data_ptr(),
                 count=count)
    return _nms_walk(sorted_boxes, sorted_scores, n_post, nms_iou)[:3]


def proposals_batched(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                      anchors: torch.Tensor, img_size, *, nms_iou: float,
                      n_post_nms: int, min_size: float, n_pre_nms=None,
                      use_kernel: bool = True):
    """Proposals for a batch, on the route the JAX package takes.

    Args:
      rpn_locs: ``[B, N, 4]``.  rpn_fg_scores: ``[B, N]``.
      anchors: ``[N, 4]``.  img_size: ``(H, W)``.
      n_pre_nms: exact pre-NMS cut, engaged when ``6 * n_pre_nms <= N``
        (kernel 1); otherwise the whole table goes through kernel 3.

    Returns ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    n = rpn_locs.shape[1]
    kw = dict(nms_iou=nms_iou, n_post_nms=n_post_nms, min_size=min_size,
              use_kernel=use_kernel)
    if n_pre_nms is None or 6 * n_pre_nms > n:
        return fused_proposals_batched(rpn_locs, rpn_fg_scores, anchors,
                                       img_size, **kw)
    roi, masked = _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size,
                                 min_size)
    top_scores, top_idx = topk_stable(masked, n_pre_nms)
    top_boxes = torch.gather(roi, 1, top_idx[..., None].expand(-1, -1, 4))
    return greedy_nms(top_boxes.contiguous(), top_scores.contiguous(),
                      n_post=n_post_nms, iou_threshold=nms_iou,
                      use_kernel=use_kernel)[:3]
