#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Builds the port's CUDA kernels from ``two_stage_object_detection_tpu_torch/
csrc`` (one nvcc per source, in parallel), holds each kernel against its
plain PyTorch version at the shapes of the path that runs it, and times
both; kernels 1 and 2 at the flagship's predict and train shapes (kernel 1
K=3000 -> 300 and K=12,000 -> 600, bit for bit, also on images with every
row masked, with fewer survivors than ``n_post`` and with one box
repeated; kernel 2 R=300 and R=128), kernel 3 (two launches: decode and
sort in ``csrc/proposals.cu``, kernel 1's walk in ``csrc/nms.cu``) bit for
bit at the single scale's 12,996 anchors (n_post 300 and 600), at the
16,368 of a 256x256 FPN input and at the 65,472 of a 512x512 one (n_post
600, B=4), kernel 5 values and argmax at R=300 and R=128, kernel 6 and
kernel 5b (kernel 5's scatter backward) on both routes of their plan (the
gradient slice in shared memory at B=16, 38x38x512; global atomics on a
128x128 map at B=2) within their stated tolerance, and kernels 1 and 3 bit
for bit above the 112,128 rows one walk launch holds (112,129 and 250,000
rows at B=2, walked in chunks).  Then it
serves requests through the port's ``Predictor`` on
two paths, each at full width (600x600, 81 classes, 100 detections,
bfloat16, seeded random weights), with every launch counter set to 0 just
before and read just after:

* the FPN flagship (ResNet-50 FPN, 3000 -> 300 proposals): kernels 1 and 2;
* the default ``Config()`` (HarDNet-39, single scale, 12,996 anchors,
  whole-table 300 proposals): kernels 3 and 5.

Kernel 4, kernel 3's one-image launch, is off both paths (as the JAX
package's ``_fused_kernel`` is off its predict path): it is checked and
timed here, and its launch count on the paths is 0.

It checks f32 predict with the kernels against ``pallas="off"`` on both
paths.

Then it trains, on three paths at full width: the flagship (kernels 1
and 2 under the hybrid RoIAlign), the single scale with ``roi_bwd="pallas"``
(kernels 3, 5 and 6) and the single scale with ``pallas_roi=True`` (kernels
3 and 5 and kernel 5's scatter backward).  Each is a ``create_train_state``
and four ``train_step`` micro-steps at batch 16 with ``grad_accum_steps=2``,
counters set to 0 just before.  Every loss must be finite, the parameters
must move at the second micro-step and not at the first, the running
statistics at the first, and the path's kernels must have launched.  For
each path one f32 ``train_forward`` + backward at batch 2 is held against
``pallas="off"`` (losses and every gradient leaf; on the flagship with the
box head's ReLU inputs moved off 0 first, and the ReLU masks equal).  The
kernels line sums the launches of these paths and the served ones, and of
nothing else.  Last, two micro-steps each of ``roi_bwd="xla"`` and
``"structured"`` run at batch 2, side routes whose launches are printed on
their own.

Last, the drivers phase runs the flagship through the port's CLI
(``__main__.main``, in this process) over the host data pipeline, on a data
root that lists the three committed JPEGs of ``tests/data/real_coco`` 32
times for training and 16 for evaluation: ``train`` for two epochs at batch
16 with ``grad_accum_steps=2`` and an eval after each (counters set to 0
just before; kernels 1 and 2 must launch, the losses be finite, both
checkpoints be written and ``_last`` hold step 4 and 2 updates), ``eval`` of
the best checkpoint in both protocols (four finite values, mAPs in [0, 1]),
and a ``Predictor.from_checkpoint`` serving one 3-image u8 request.  Between
train and eval, the same ``train`` runs on a root of 128 training images
(8 micro-steps an epoch, an eval after epoch 1 only), and then its train
loader runs alone, with thread and with process workers.  It prints the
decoder and the loader's copy scheme it found, each train loop's images per
second over epoch 2 with its time a micro-step beside the bare b=16
micro-step of the train phase, the loader's rate alone, and each eval
pass's seconds.  Its launches stay out of the kernels line.

Then three phases for the routes without a hand kernel of their own, each
at full width with random weights from seed 0:

* RoI routes: the flagship with ``fpn_roi_window=0`` (dense RoIAlign over
  P2..P5, blended by level) and the single-scale ``Config()`` with
  ``roi_pool_mode="align"`` and ``"mean"``.  For each, a b=16 predict
  through a ``Predictor`` (finite outputs, valid counts in range, its
  ``roi_head`` stage time beside the kernel route's), an f32 (TF32 off)
  predict on the card against the same on the CPU from the card's
  features (the tolerances of the f32 parity above), and two b=16 train
  micro-steps (finite losses, the parameters moved, peak memory), counters
  set to 0 just before each: kernel 1 (flagship) or kernel 3 (single scale)
  must launch, and kernel 2 on the dense route, kernel 5 on ``align`` and
  ``mean``, must not.
* Device augmentation: ``augment_batch`` at b=16, 600x600 on the card,
  timed, and ``apply_augment`` of the same draws on the card against the
  CPU (images within 1e-4, boxes exact).
* Resident train loop: the flagship through the CLI over the 128-image root
  of the drivers phase with ``cache_device``, ``device_augment``,
  ``transfer_uint8`` and ``fused_accum`` on: the epoch records must name the
  resident loop, which they do only when the train loader is the cache (so
  a fallback to the streaming loader fails the run); its epoch-2 rate and
  time a micro-step beside the streaming loop's and the bare micro-step's,
  the cache's bytes on the card, and ``eval`` over the cached eval set in
  both protocols with its seconds.  Then one epoch of the same loop over a
  cache of 32 images runs under the sync debug mode and ``torch.profiler``:
  it fails on any synchronising call, and on as many host-to-device copies
  as micro-steps, and prints the card's idle share over the epoch.

Their launches are printed on their own lines and stay out of the kernels
line.

Last, the serving phase, on the flagship at full width (bf16, and f32 with
TF32 off where outputs are compared), its requests the three committed
JPEGs decoded to 600x600 and tiled, counters set to 0 just before each step:

* yuv420: the unpack of 16 packed planes on the card against
  ``yuv420_to_rgb_reference`` bit for bit; ``Predictor(wire="yuv420")``
  against the f32 wire fed that reference (the f32 parity's tolerances);
  each wire's time for a 16-image request.
* ``calibrate=True`` over buckets (1, 2, 8, 16): each bucket's measured ms
  and the plan for 1-16 images.
* Pipelined dispatch: one 48-image request (three buckets) against three
  16-image requests, and the synchronising calls in that request under the
  sync debug mode.
* ``DynamicBatcher``: 16 threads submit 64 one-image requests (f32), each
  answer held against a direct call; images/s, p50/p99 latency, flushes;
  kernels 1 and 2 must launch.
* HTTP: ``DetectionServer`` on 127.0.0.1, 8 client threads post the three
  JPEGs 8 times each (200, boxes inside each original image); garbage bytes
  400, ``/nope`` 404, ``/healthz`` ok; requests/s.
* Export: ``export_program(portable=False)`` of the flagship and of
  ``Config()`` at b=16 (f32), saved, loaded and run on the card: kernels 1
  and 2, and 3 and 5, must launch from the loaded programs, whose outputs
  are held against eager predict; ``portable=True`` at b=1 must launch no
  kernel, held against eager ``pallas="off"``.  Export seconds, bytes and
  the loaded b=16 time beside eager.
* int8: for three backbone convs (the stem, K=147; a 3x3 over 64 channels;
  a 3x3 over 512) the ``torch._int_mm`` accumulators against the float64
  convolution, bit for bit; ``calibrate`` on 4 images,
  ``filter_scales("extractor")`` and a 16-image request through
  ``Predictor(int8_scales=...)``, its time beside bf16.

Its launches are printed on their own lines and stay out of the kernels
line.

Then the ``.pth`` import phase (``utils/torch_import.py``), cuDNN
deterministic: ``export_state_dict`` of a seeded HarDNet-39 ``Config()``
model goes through a reference-layout ``.pth`` file into a model of other
weights with ``load_torch_checkpoint``, whose b=16 predict must equal the
source's bit for bit; a seeded torchvision-layout ResNet-50 dict (no PReLU
slopes) goes through a ``.pth`` file into the flagship's trunk with
``load_resnet_backbone(blocks_num=(3, 4, 6, 3))``, whose four taps must
equal bit for bit those of the same weights set directly (slopes 0).  Each
import's seconds are printed.

Last, the data-parallel phase (``parallel/``), on the flagship at full
width, float32 with TF32 off and cuDNN deterministic where results are
compared:

* ``Predictor(mesh=)`` over the card's one device: bit for bit the
  meshless ``Predictor`` on a 16-image u8 request (bf16).
* NCCL, a world of 1 (a file store in a temporary directory): two
  micro-steps and one update of the mesh train step at b=4 equal the
  meshless step's bit for bit (the gradient all-reduce runs over NCCL).
* Gloo, 2 ranks spawned on ``cuda:0`` (NCCL refuses two ranks on one
  card; gloo's collectives are staged through pinned host memory), 8 images
  a rank of two 16-image batches, ``grad_accum_steps=2``: rank 0's weights
  are broadcast to the other (held equal bit for bit); eval, through the
  train graph, with each batch split over the ranks and gathered, equal bit
  for bit to one process over the same blocks of 8; two micro-steps and one
  update, after which the ranks' states are equal bit for bit and kernels 1
  and 2 have launched in each (counters set to 0 just before).  Before the
  micro-steps, one forward of the first batch holds the cross-replica
  batch norm's statistics at each of its 53 layers against float64, as
  they enter the normalised output (within 1e-5; the float32 combine it
  replaced is printed beside).  Against one process at b=16 on the same
  batches: the running statistics within 1e-5 (they depend on the images
  and weights alone, so the cross-replica batch norm must give the global
  batch's); the total loss within 1e-3 relative; 99% of parameter
  elements within 1e-5 + 1e-5 |p| after the update (AdamW's first update
  turns the sign of a near-zero gradient into a step of ``lr``); and the
  all-reduced gradient, in norm, within twice the relative error of a
  rounding control, one process on each batch's images in reverse order
  (at full width with random weights a rounding-level difference flips
  some proposal, sampling and ReLU decisions, which moves the gradient by a
  few 1e-3; a missing all-reduce or a wrong scale is off by 0.5-1).  The
  gradient errors are printed by module for the ranks, the rounding
  control and a half-batch control (one process on the ranks' halves as
  micro-steps of their own: their convolution batch size, and a batch norm
  over 8 images).  ``should_stop(sync=True)`` with one rank asking at poll
  3 stops both at poll 4.  Each rank prints its micro-step times, the
  gradient all-reduce's time on its bytes, and its peak memory.
* Tensor parallel: 4 gloo ranks on ``cuda:0`` as a ``(2, 2)`` mesh (ranks
  ``d * 2 + m``), from the same weights, data index ``d`` on the rows the
  data-parallel rank ``d`` trained on; ``fc1``, ``fc2`` and ``cls_loc``
  split over each model group (``score [81, 1024]`` does not divide).  Two
  micro-steps and one update, kernels 1 and 2 launched in every rank.
  Against the data-parallel ranks: the box head's outputs of the first
  micro-step within 1e-5 relative in norm, the all-reduced gradient
  gathered into the full layout within 1e-4; each data group's states and
  each model group's replicated tensors equal bit for bit after the
  update; the ranks' gathered checkpoint restored into one process on the
  card predicts bit for bit like a model holding the gathered parameters.
  Each rank prints its micro-step times beside the data-parallel rank's,
  its model group's gathers and all-reduces a micro-step (count, bytes,
  time), its peak memory beside the data-parallel rank's, and its
  launches.

Every check raises on failure, so any failed phase exits nonzero; a rank
that raises fails the phase.

Output: progress lines; the card's ``nvidia-smi`` name and power limit; one
JSON line ``{"kernels": [...]}`` with each kernel's launches, error, times
and bound; and last, ``{"ok": true, "device": {...}}``.  With ``--json``,
the measured numbers also go to that file.  Without a CUDA device,
or outside the repository, it exits nonzero and prints no result.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# non-tensor-core float32 rate.  Bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
IOU_FLOPS = 14            # max/min x4, sub x2, clamp x2, mul, add, sub, add, div, cmp
DECODE_FLOPS = 26         # anchor w/h/centre 6, deltas 4, exp 2, box 4, clip 8, sides 2


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ kernel 1
def nms_inputs(rng, b: int, k: int, dev, edges: bool = False):
    """Score-sorted rows (stable, ties by lower index) with score ties,
    near-threshold pairs (IoU ~ 0.7) and masked (-1e9) tail rows.  With
    ``edges``, image 0 has every row masked, image 1 only 50 valid rows
    (fewer survivors than ``n_post``) and image 2 one box repeated with 2 px
    of jitter (each kept row suppresses nearly every later one, so the walk
    reaches the last tile)."""
    xy = rng.rand(b, k, 2) * 560.0
    wh = rng.rand(b, k, 2) * 200.0 + 16.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    w = boxes[:, 0:k:4, 2] - boxes[:, 0:k:4, 0]
    d = w * (0.3 / 1.7) * (1.0 + rng.uniform(-1e-6, 1e-6, w.shape))
    partner = boxes[:, 0:k:4].copy()
    partner[..., 0] += d
    partner[..., 2] += d
    boxes[:, 1:k:4] = partner
    scores = (rng.randint(0, 200, size=(b, k)) / 200.0).astype(np.float32)
    scores[:, k - k // 20:] = -1e9
    if edges:
        scores[0] = -1e9
        scores[1, 50:] = -1e9
        boxes[2] = (np.array([100.0, 120.0, 260.0, 250.0], np.float32)
                    + rng.rand(k, 4).astype(np.float32) * 2.0)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores = np.take_along_axis(scores, order, 1)
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


def nms_bound_ms(boxes, out_boxes, valid, n_post: int):
    """Bytes: inputs once, outputs once.  Operations: the IoUs greedy NMS
    needs on this data -- each kept row i against the K - 1 - i rows after
    it -- plus one area per row."""
    b, k, _ = boxes.shape
    nbytes = b * k * (16 + 4) + b * n_post * (16 + 4 + 1)
    # row index of each kept box in its image
    match = (out_boxes[:, :, None, :] == boxes[:, None, :, :]).all(-1)
    row = match.to(torch.uint8).argmax(-1)
    ious = int(((k - 1 - row) * valid).sum())
    ops = ious * IOU_FLOPS + b * k * 3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# kernel 1's (K, n_post): predict, then train; kernel 2's R: the same
NMS_SHAPES = ((3000, 300), (12000, 600))
ALIGN_ROIS = (300, 128)


def check_nms(rng, dev):
    """Kernel 1 at the predict and train shapes, B=16: bit for bit against
    the plain version, on the timed batch and on one with three edge images
    (``nms_inputs(edges=True)``).  Returns the predict shape's row of the
    kernels line and each shape's numbers."""
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        greedy_nms, greedy_nms_rows_reference)
    shapes = {}
    for k, n_post in NMS_SHAPES:
        for edges in (False, True):
            boxes, scores = nms_inputs(rng, 16, k, dev, edges=edges)
            run = lambda: greedy_nms(boxes, scores, n_post=n_post,  # noqa: E731
                                     iou_threshold=0.7)
            plain = lambda: greedy_nms_rows_reference(              # noqa: E731
                boxes, scores, n_post=n_post, iou_threshold=0.7)
            got, want = run(), plain()
            torch.cuda.synchronize()
            for name, g, w in zip(("boxes", "scores", "valid"), got, want):
                require(torch.equal(g, w), f"nms K={k} edges={edges}: {name} "
                        "differ from the plain version (must be bitwise equal)")
            kept = got[2].sum(1).tolist()
            log(f"kernel greedy_nms B=16 K={k} n_post={n_post}"
                f"{' edge images' if edges else ''}: bitwise equal to plain, "
                f"{sum(kept)} kept (images 0-2: {kept[:3]})")
            if edges:
                require(kept[0] == 0 and 0 < kept[1] <= 50
                        and 0 < kept[2] < n_post,
                        f"nms K={k}: the edge images are not what they claim")
                continue
            require(sum(kept) > 0, "nms kept nothing")
            ms = cuda_time_ms(run, 50 if k <= 3000 else 20)
            plain_ms = cuda_time_ms(plain, 2, warmup=1)
            bound_ms, bound_by = nms_bound_ms(boxes, got[0], got[2], n_post)
            log(f"kernel greedy_nms B=16 K={k} n_post={n_post}: {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            shapes[f"K{k}"] = dict(
                n_post=n_post, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, kept=sum(kept),
                max_abs_err=float((got[0] - want[0]).abs().max()))
    pred = shapes[f"K{NMS_SHAPES[0][0]}"]
    row = dict(name="greedy_nms", route="cuda",
               source="two_stage_object_detection_tpu_torch/csrc/nms.cu",
               replaces="two_stage_object_detection_tpu/ops/pallas_proposals.py:230",
               library_ms=None, **{key: pred[key] for key in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
    return row, shapes


# ------------------------------------------------------------ kernel 2
LEVELS_HW = ((150, 150), (75, 75), (38, 38), (19, 19))
IMG = 600


def align_inputs(rng, dev, dtype, b=16, r=300, c=256):
    """P2..P5 of a 600x600 image; rois of all sizes, some hanging over the
    image edge; levels as the FPN head assigns them, except for a tenth of
    elongated rois (aspect 8-20) left on their eq.-1 level, where the
    window does not cover them and the edge clamp engages."""
    from two_stage_object_detection_tpu_torch.nets.fpn import (
        fpn_level_assign, span_aware_levels)
    g = torch.Generator(device="cpu").manual_seed(int(rng.randint(1 << 30)))
    pyr = [torch.randn((b, h, w, c), generator=g).to(dev, dtype)
           for h, w in LEVELS_HW]
    side = rng.choice([24.0, 64.0, 160.0, 400.0], size=(b, r)) * rng.uniform(
        0.7, 1.4, size=(b, r))
    ar = rng.uniform(0.5, 2.0, size=(b, r))
    ar[:, : r // 10] = rng.uniform(8.0, 20.0, size=(b, r // 10))
    x1 = rng.rand(b, r) * IMG * 0.9 - IMG * 0.05
    y1 = rng.rand(b, r) * IMG * 0.9 - IMG * 0.05
    rois = np.stack([x1, y1, x1 + side * np.sqrt(ar), y1 + side / np.sqrt(ar)],
                    -1).astype(np.float32)
    rois = torch.from_numpy(rois).to(dev)
    scales = tuple((h / IMG, w / IMG) for h, w in LEVELS_HW)
    eq1 = fpn_level_assign(rois, 2, 5) - 2
    levels = span_aware_levels(rois, eq1, scales, 30.0)
    # the elongated tenth keeps its eq.-1 level: windows that do not cover
    levels[:, : r // 10] = eq1[:, : r // 10]
    return pyr, rois, levels.to(torch.int32).contiguous(), scales


def touched_bytes(pyr, rois, levels, scales, win=32, p=7, s=2):
    """Bytes of the distinct pyramid pixels the rois' bilinear taps read:
    over the whole batch (each pixel once: the HBM bound), and summed over
    the rois (each pixel once per roi that reads it: the least one block a
    roi brings into its SM)."""
    from two_stage_object_detection_tpu_torch.ops import roi_pool
    dev = rois.device
    sizes = torch.tensor(LEVELS_HW, dtype=torch.float32, device=dev)
    sc = roi_pool._norm_scales(scales, len(LEVELS_HW)).to(dev)
    lv = levels.long()
    cy, cx = roi_pool._roi_samples(rois, lv, sizes, sc, p, s, False)
    w_pad = max(max(w for _, w in LEVELS_HW), win)
    block_h = torch.tensor([max(h, win) for h, _ in LEVELS_HW], device=dev)
    oy = torch.minimum(torch.clamp(torch.floor(cy[..., 0]).long(), min=0),
                       block_h[lv] - win)
    ox = torch.clamp(torch.floor(cx[..., 0]).long(), 0, w_pad - win)

    def taps(c, o):
        loc = torch.clamp(c - o[..., None].float(), 0.0, win - 1.0)
        i0 = torch.floor(loc).long()
        return torch.cat([i0, torch.clamp(i0 + 1, max=win - 1)], -1) + o[..., None]

    ty, tx = taps(cy, oy), taps(cx, ox)                  # [B, R, 2*P*S]

    def distinct(t, lim):       # taps of a roi inside its level's map
        v = torch.where(t < lim[..., None], t, -1).sort(-1).values
        new = torch.ones_like(v, dtype=torch.bool)
        new[..., 1:] = v[..., 1:] != v[..., :-1]
        return (new & (v >= 0)).sum(-1)

    # a roi's taps are a grid: its pixels are its rows times its columns
    per_roi = int((distinct(ty, sizes[lv, 0].long())
                   * distinct(tx, sizes[lv, 1].long())).sum())
    total = 0
    bidx = torch.arange(rois.shape[0], device=dev)[:, None, None, None]
    for li, (h, w) in enumerate(LEVELS_HW):
        m = lv == li
        occ = torch.zeros((rois.shape[0], h, w), dtype=torch.bool, device=dev)
        yy = ty[..., :, None].expand(-1, -1, -1, tx.shape[-1])
        xx = tx[..., None, :].expand(-1, -1, ty.shape[-1], -1)
        ok = m[..., None, None] & (yy < h) & (xx < w)
        bb = bidx.expand_as(yy)
        occ[bb[ok], yy[ok], xx[ok]] = True
        total += int(occ.sum())
    pixel = pyr[0].shape[-1] * pyr[0].element_size()
    return total * pixel, per_roi * pixel


def check_align(rng, dev):
    """Kernel 2 at the predict (R=300) and train (R=128) shapes, B=16,
    C=256: f32 within 1e-5 of the plain version, bf16 within one bf16
    rounding of the plain version run in f32; each shape timed in bf16
    against its bound.  Returns the predict shape's row of the kernels line
    and each shape's numbers."""
    from two_stage_object_detection_tpu_torch.ops.windowed_align import (
        windowed_roi_align_batched)
    shapes = {}
    for r in ALIGN_ROIS:
        # float32: the kernel equals the plain version to summation order
        pyr, rois, levels, scales = align_inputs(rng, dev, torch.float32, r=r)
        got = windowed_roi_align_batched(pyr, rois, levels, scales)
        want = windowed_roi_align_batched(pyr, rois, levels, scales,
                                          use_kernel=False)
        err32 = float((got - want).abs().max())
        log(f"kernel windowed_align f32 B=16 R={r} C=256: max |diff| "
            f"{err32:.3e} (tolerance 1e-5)")
        require(err32 <= 1e-5, f"windowed_align f32 R={r} differs by {err32}")
        del pyr, got, want
        # bfloat16: the kernel accumulates in f32 and rounds once, so it is
        # within one bf16 rounding (2^-8 relative) of the plain version run
        # in f32 on the same bf16 features
        pyr, rois, levels, scales = align_inputs(rng, dev, torch.bfloat16, r=r)
        got = windowed_roi_align_batched(pyr, rois, levels, scales)
        want = windowed_roi_align_batched([p.float() for p in pyr], rois,
                                          levels, scales, use_kernel=False)
        diff = (got.float() - want).abs()
        tol = 2.0 ** -8 * want.abs() + 1e-5
        err = float(diff.max())
        log(f"kernel windowed_align bf16 R={r}: max |diff| {err:.3e}, worst "
            f"diff/tol {float((diff / tol).max()):.3f} (tolerance "
            "2^-8*|ref| + 1e-5)")
        require(bool((diff <= tol).all()), f"windowed_align bf16 R={r} "
                "outside tolerance")
        del want, diff, tol

        ms = cuda_time_ms(lambda: windowed_roi_align_batched(
            pyr, rois, levels, scales), 20)
        plain_ms = cuda_time_ms(lambda: windowed_roi_align_batched(
            pyr, rois, levels, scales, use_kernel=False), 3, warmup=1)
        n_roi, c = rois.shape[0] * rois.shape[1], pyr[0].shape[-1]
        touched, per_roi = touched_bytes(pyr, rois, levels, scales)
        nbytes = (touched + n_roi * (16 + 4)
                  + n_roi * 49 * c * pyr[0].element_size())
        ops = n_roi * c * (49 * 16 * 3 + 49)   # 16 taps x (w*w, *v, +) per bin
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel windowed_align bf16 B=16 R={r} C=256: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); the rois' "
            f"footprints, each pixel once per roi: {per_roi / 1e6:.1f} MB")
        shapes[f"R{r}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, max_abs_err=err,
                               max_abs_err_f32=err32, bytes=nbytes,
                               footprint_bytes=per_roi)
        del pyr, got
    pred = shapes[f"R{ALIGN_ROIS[0]}"]
    row = dict(name="windowed_align", route="cuda",
               source="two_stage_object_detection_tpu_torch/csrc/windowed_align.cu",
               replaces="two_stage_object_detection_tpu/ops/pallas_windowed_align.py:52",
               library_ms=None, **{key: pred[key] for key in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
    return row, shapes


# ------------------------------------------------------------ kernels 3/4
def fused_inputs(rng, b: int, dev, cfg):
    """The anchors of ``cfg`` (12,996 for ``Config()``, 16,368 for an FPN
    input of 256x256), rows 3k+1 given
    the anchor of row 3k: row 3k decodes to it exactly and 3k+1 to it
    shifted along x at IoU ~ 0.7 (+-1e-5); coarse scores (ties); every 8th
    row shrunk under the 16 px minimum."""
    from two_stage_object_detection_tpu_torch.ops.anchors import (
        make_anchors, make_fpn_anchors)
    anchors = make_fpn_anchors(cfg) if cfg.fpn else make_anchors(cfg)
    n = anchors.shape[0]
    anchors[1::3] = anchors[0::3][: len(anchors[1::3])]
    locs = rng.randn(b, n, 4) * 0.2
    locs[:, 0::3] = 0.0
    locs[:, 1::3] = 0.0
    m = locs[:, 1::3].shape[1]
    locs[:, 1::3, 0] = 0.3 / 1.7 * (1.0 + rng.uniform(-1e-5, 1e-5, (b, m)))
    locs[:, 2::8, 2:] = -4.0
    fg = rng.randint(0, 200, size=(b, n)) / 200.0
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (locs, fg, anchors))


def alive_ious(locs, fg, anchors, img, n_post: int, min_size: float,
               thr: float) -> int:
    """IoUs that greedy NMS needs on this data: at each valid step, the
    winner against every row still alive (masked and suppressed rows need
    none)."""
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        _decode_masked)
    boxes, s = _decode_masked(locs, fg, anchors, img, min_size)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    total = torch.zeros((), dtype=torch.int64, device=boxes.device)
    for _ in range(n_post):
        alive = s > -5e8
        i = torch.argmax(s, dim=1)
        ok = alive[rows, i]
        total += (alive.sum(1) * ok).sum()
        sel = boxes[rows, i]
        inter = (torch.clamp(torch.minimum(x2, sel[:, 2:3])
                             - torch.maximum(x1, sel[:, 0:1]), min=0.0)
                 * torch.clamp(torch.minimum(y2, sel[:, 3:4])
                               - torch.maximum(y1, sel[:, 1:2]), min=0.0))
        iou = inter / (area + area[rows, i][:, None] - inter + 1e-8)
        sup = iou > thr
        sup[rows, i] = True
        s = torch.where(sup, -1e9, s)
    return int(total)


def fused_bound_ms(locs, fg, anchors, img, n_post: int):
    b, n, _ = locs.shape
    nbytes = b * n * (16 + 4) + n * 16 + b * n_post * (16 + 4 + 1)
    ops = (alive_ious(locs, fg, anchors, img, n_post, 16.0, 0.7) * IOU_FLOPS
           + b * n * DECODE_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sort_ms(locs, fg, anchors, img, iters: int = 20) -> float:
    """Device time of kernel 3's launch A alone (decode, mask, sort)."""
    from two_stage_object_detection_tpu_torch.ops import _cuda
    from two_stage_object_detection_tpu_torch.ops import proposals as P
    b, n, _ = locs.shape
    keys = torch.empty((b, n), dtype=torch.int64, device=locs.device)
    boxes = torch.empty((b, n, 4), dtype=torch.float32, device=locs.device)
    scores = torch.empty((b, n), dtype=torch.float32, device=locs.device)
    fn = P._sort_fn()

    def run():
        _cuda.check(fn(locs.data_ptr(), fg.data_ptr(), anchors.data_ptr(), b,
                       n, 16.0, float(img[0]), float(img[1]), keys.data_ptr(),
                       boxes.data_ptr(), scores.data_ptr(),
                       _cuda.stream_handle(locs)), "proposals_sort_launch")
    return cuda_time_ms(run, iters)


# kernel 3's shapes: (label, config, B, n_post); the first three are the
# single-scale predict and train launches and kernel 4's one-image launch
FUSED_SHAPES = (("predict", None, 16, 300), ("train", None, 16, 600),
                ("one image", None, 1, 300), ("FPN 256", (256, 256), 16, 300),
                ("FPN 512 train", (512, 512), 4, 600))


def check_fused(rng, dev):
    """Kernel 3 at B=16 (predict n_post 300, train n_post 600) and kernel 4
    (B=1), bit for bit against the plain version and timed; then kernel 3
    on the 16,368 anchors of an FPN input of 256x256 (the predict's
    whole-table route, as 6 * 3000 > 16,368) and on the 65,472 anchors of
    one of 512x512 at the train's n_post (its whole-table route, as
    6 * 12,000 > 65,472; B=4), checked and timed but not rows of the
    kernels line.  Each timed shape also times launch A alone.  Returns the
    rows of kernels 3 and 4 and each shape's numbers."""
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        fused_proposals, fused_proposals_batched,
        fused_proposals_rows_reference)
    kw = dict(nms_iou=0.7, min_size=16.0)
    rows, shapes = [], {}
    for label, size, b, n_post in FUSED_SHAPES:
        cfg = (Config() if size is None else
               Config(fpn=True, backbone="resnet50", input_size=size))
        img = cfg.input_size
        locs, fg, anchors = fused_inputs(rng, b, dev, cfg)
        n = locs.shape[1]
        if b == 1:
            run = lambda: [t[None] for t in fused_proposals(      # noqa: E731
                locs[0], fg[0], anchors, img, n_post_nms=n_post, **kw)]
        else:
            run = lambda: fused_proposals_batched(                 # noqa: E731
                locs, fg, anchors, img, n_post_nms=n_post, **kw)
        plain = lambda: fused_proposals_rows_reference(            # noqa: E731
            locs, fg, anchors, img, n_post_nms=n_post, **kw)
        got, want = run(), plain()
        torch.cuda.synchronize()
        n_diff = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = float((got[0] - want[0]).abs().max())
        n_valid = int(got[2].sum())
        name = "fused_proposals" if b == 1 else "fused_proposals_batched"
        log(f"kernel {name} B={b} N={n} n_post={n_post} ({label}): {n_diff} "
            f"elements differ from plain, {n_valid} kept, max |box diff| "
            f"{err:.3e}")
        require(n_diff == 0, f"{name} N={n} n_post={n_post}: outputs differ "
                "from the plain version (must be bitwise equal)")
        require(n_valid > 0, f"{name} kept nothing")
        ms = cuda_time_ms(run, 20)
        a_ms = sort_ms(locs, fg, anchors, img)
        plain_ms = cuda_time_ms(plain, 3, warmup=1)
        bound_ms, bound_by = fused_bound_ms(locs, fg, anchors, img, n_post)
        log(f"kernel {name} B={b} N={n} n_post={n_post}: {ms:.4f} ms (launch "
            f"A alone {a_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
        shapes[f"{label} N{n} n_post{n_post} B{b}"] = dict(
            ms=ms, launch_a_ms=a_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, kept=n_valid, max_abs_err=err)
        if label not in ("predict", "one image"):
            continue
        line = 43 if b == 1 else 191
        rows.append(dict(
            name=name, route="cuda",
            source="two_stage_object_detection_tpu_torch/csrc/proposals.cu",
            sources=["two_stage_object_detection_tpu_torch/csrc/proposals.cu",
                     "two_stage_object_detection_tpu_torch/csrc/nms.cu"],
            replaces=f"two_stage_object_detection_tpu/ops/pallas_proposals.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))
    return rows, shapes


# ------------------------------------------------------------ kernel 5
def roi_pool_inputs(rng, dev, b=16, r=300, c=512, hw=38, img=600.0):
    """A bf16 38x38x512 map per image with coarse values (ties inside
    bins) and a constant patch; 300 rois of 16..600 px clipped to the image
    as proposals are, except a tenth left over its edge (empty bins),
    scaled to the map as the RoI head scales them."""
    g = torch.Generator(device="cpu").manual_seed(int(rng.randint(1 << 30)))
    feats = torch.randint(-64, 64, (b, hw, hw, c), generator=g) / 16.0
    feats[:, 5:15, 5:15] = 1.5
    feats = feats.to(dev, torch.bfloat16)
    side = rng.uniform(16.0, 600.0, size=(b, r, 2))
    xy = rng.rand(b, r, 2) * img * 1.1 - img * 0.05 - side / 2
    rois = np.concatenate([xy, xy + side], -1).astype(np.float32)
    rois[:, r // 10:] = np.clip(rois[:, r // 10:], 0.0, img)
    scale = torch.tensor([hw / img] * 4, dtype=torch.float32)
    return feats, (torch.from_numpy(rois) * scale).to(dev)


def bin_pixels(rois, h: int, w: int, p: int = 7) -> int:
    """Pixels in all bins of ``rois [B, R, 4]`` (map coordinates)."""
    from two_stage_object_detection_tpu_torch.ops.roi_pool import (
        _bin_edges_pool)
    q = torch.round(rois).to(torch.int64)
    xs, xe = _bin_edges_pool(q[..., 0], q[..., 2], p)
    ys, ye = _bin_edges_pool(q[..., 1], q[..., 3], p)
    bw = (xe.clamp(0, w) - xs.clamp(0, w)).clamp(min=0)
    bh = (ye.clamp(0, h) - ys.clamp(0, h)).clamp(min=0)
    return int((bh[..., :, None] * bw[..., None, :]).sum())


def roi_pool_bound_ms(feats, rois, p: int = 7, out_bytes: int = 8):
    """Bytes: the map and rois read once, the f32 values and (with
    ``out_bytes=8``) int32 indices written once.  Operations: one compare
    per pixel of each bin per channel."""
    b, h, w, c = feats.shape
    r = rois.shape[1]
    ops = bin_pixels(rois, h, w, p) * c
    nbytes = (feats.numel() * feats.element_size() + rois.numel() * 4
              + b * r * p * p * c * out_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def check_roi_pool(rng, dev):
    """Kernel 5 at B=16, C=512, 38x38, P=7 from bf16 maps, at the predict's
    R=300 and the train's R=128: values and argmax equal to the plain
    version (run one image at a time), and the launch without the index
    store equal too; each timed.  Beside the HBM bound it prints what the
    direct scan (the design before the map slice in shared memory) pulls
    from L2: every bin's pixels x C x 2 bytes.  Returns the R=300 row of
    the kernels line and each shape's numbers."""
    from two_stage_object_detection_tpu_torch.ops.roi_pool import (
        roi_pool_argmax)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_max, roi_pool_plan)
    shapes, row = {}, None
    for r in (300, 128):
        feats, rois = roi_pool_inputs(rng, dev, r=r)
        b, h, w, c = feats.shape
        plan = roi_pool_plan(b, h, w, c, r, feats.element_size(),
                             torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        got = roi_pool_max(feats, rois, with_argmax=True)

        def plain():
            return [roi_pool_argmax(feats[i:i + 1], rois[i:i + 1])
                    for i in range(feats.shape[0])]

        want = plain()
        torch.cuda.synchronize()
        n_diff = sum(int((got[0][i] != v[0]).sum() + (got[1][i] != a[0]).sum())
                     for i, (v, a) in enumerate(want))
        err = max(float((got[0][i] - v[0]).abs().max())
                  for i, (v, _) in enumerate(want))
        n_empty = int((got[1] < 0).sum())
        log(f"kernel roi_pool_max bf16 B={b} R={r} C={c} {h}x{w} P=7 ({plan}): "
            f"{n_diff} elements differ from plain (values and argmax), "
            f"{n_empty} empty cells")
        require(n_diff == 0, f"roi_pool_max R={r} differs from the plain "
                "version (values and argmax must be equal)")
        del want
        # the launch that no backward follows: no index buffer, half the bytes
        values, none = roi_pool_max(feats, rois, with_argmax=False)
        require(none is None and torch.equal(values, got[0]),
                f"roi_pool_max R={r} without the index store gives other "
                "values")
        del values
        ms = cuda_time_ms(lambda: roi_pool_max(feats, rois, with_argmax=True),
                          20)
        v_ms = cuda_time_ms(lambda: roi_pool_max(feats, rois,
                                                 with_argmax=False), 20)
        plain_ms = cuda_time_ms(plain, 2, warmup=1)
        bound_ms, bound_by, nbytes = roi_pool_bound_ms(feats, rois)
        v_bound, v_by, v_bytes = roi_pool_bound_ms(feats, rois, out_bytes=4)
        l2_bytes = bin_pixels(rois, h, w) * c * feats.element_size()
        log(f"kernel roi_pool_max B={b} R={r} C={c}: {ms:.4f} ms, values only "
            f"{v_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes / 1e6:.1f} MB), values only {v_bound:.5f} "
            f"ms ({v_by}: {v_bytes / 1e6:.1f} MB); the direct scan's L2 -> SM "
            f"bytes (bin pixels x C x 2): {l2_bytes / 1e6:.1f} MB")
        shapes[f"R{r}"] = dict(ms=ms, values_only_ms=v_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               values_only_bound_ms=v_bound,
                               bytes=nbytes, l2_scan_bytes=l2_bytes,
                               max_abs_err=err, plan=plan)
        if row is None:
            row = dict(name="roi_pool_max", route="cuda",
                       source="two_stage_object_detection_tpu_torch/csrc/roi_pool.cu",
                       replaces="two_stage_object_detection_tpu/ops/pallas_roi.py:38",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del feats, got
    return row, shapes


# ------------------------------------------------------ kernel 6, scatter
def roi_pool_bwd_inputs(rng, dev, b=16, r=128, c=512, hw=38, img=600.0):
    """The train step's shapes.  A 38x38x512 map per image that ends in a
    ReLU: coarse values (ties inside bins), exact zeros in half the cells
    (the ties a real map has) and a constant patch; 128 rois as
    ``roi_pool_inputs`` makes them, a tenth over the image's edge (empty
    bins); an f32 cotangent with every 8th roi all zero (padded samples)."""
    g = torch.Generator(device="cpu").manual_seed(int(rng.randint(1 << 30)))
    feats = torch.randint(-64, 64, (b, hw, hw, c), generator=g) / 16.0
    feats = feats.clamp(min=0.0)
    feats[:, 5:15, 5:15] = 1.5
    _, rois = roi_pool_inputs(rng, "cpu", b=b, r=r, c=4, hw=hw, img=img)
    cot = torch.randn((b, r, 7, 7, c), generator=g)
    cot[:, ::8] = 0.0
    return feats.to(dev), rois.to(dev), cot.to(dev)


# kernel 6's and 5b's shapes: (route, B, H = W, C); the slice route at the
# train step's B=16, 38x38x512 (timed, the rows of the kernels line), the
# direct route on a small batch of a map too large for any slice
BWD_SHAPES = (("slice", 16, 38, 512), ("direct", 2, 128, 64))


def check_roi_pool_bwd(rng, dev):
    """Kernel 6 and kernel 5b (kernel 5's scatter backward) at R=128, P=7,
    on both routes of ``roi_pool_bwd_plan``: the slice route at B=16,
    38x38x512 and the direct route at B=2, 128x128x64, from f32 and bf16
    maps, against their plain versions.  The kernels' additions collide in
    no fixed order (in shared memory on the slice route, global atomics on
    the direct one): a cell may differ from the plain version by f32
    rounding of its partial sums, so the tolerance is 1e-5 of the cell's
    sum of |g| (plus, from a bf16 map, one bf16 ulp of the result, 2^-7
    relative: two f32 sums a rounding error apart may round to neighbouring
    bf16 values).  Each is timed on both routes; the slice route's numbers
    are the kernels line's rows.  Returns the rows and each shape's
    numbers."""
    from two_stage_object_detection_tpu_torch.ops.roi_pool import (
        roi_pool_grad_first_argmax, scatter_argmax_grad)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
        roi_pool_bwd_recompute)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_bwd_plan, roi_pool_bwd_scatter, roi_pool_max)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, shapes = [], {}
    for route, b, hw, c in BWD_SHAPES:
        feats32, rois, g = roi_pool_bwd_inputs(rng, dev, b=b, c=c, hw=hw)
        _, h, w, _ = feats32.shape
        r = rois.shape[1]
        label = f"{route} B={b} R={r} C={c} {h}x{w} P=7"
        plans = {kind: roi_pool_bwd_plan(kind, b, h, w, c, r, elem, n_sm)
                 for kind, elem in (("recompute", 2), ("scatter", 4))}
        log(f"kernels roi_pool_bwd {label}: plans {plans}")
        require(all(p["route"] == route for p in plans.values()),
                f"roi_pool_bwd {label}: the plan takes another route")
        argmax = roi_pool_max(feats32, rois, with_argmax=True)[1]
        n_empty = int((argmax < 0).sum())
        require(n_empty > 0, "the rois leave no empty bin to test")
        mass = scatter_argmax_grad(argmax, g.abs(), h, w)   # sum of |g| a cell

        # kernel 5b: the scatter alone
        got = roi_pool_bwd_scatter(argmax, g, h, w)
        want = scatter_argmax_grad(argmax, g, h, w)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        tol = 1e-5 * mass + 1e-6
        err_scatter = float(diff.max())
        log(f"kernel roi_pool_bwd_scatter {label}: max |diff| "
            f"{err_scatter:.3e}, worst diff/tol "
            f"{float((diff / tol).max()):.3f} (tolerance 1e-5 * sum|g| + "
            f"1e-6); {n_empty} empty cells dropped")
        require(bool((diff <= tol).all()),
                f"roi_pool_bwd_scatter {label} outside tolerance")
        require(bool((got != 0).any()), "roi_pool_bwd_scatter wrote nothing")

        # kernel 6 from f32 and from bf16 maps (the values are exact in both)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            feats = feats32.to(dtype)
            got = roi_pool_bwd_recompute(feats, rois, g)
            want = roi_pool_grad_first_argmax(feats, rois, g)
            torch.cuda.synchronize()
            require(got.dtype == dtype and want.dtype == dtype,
                    "roi_pool_bwd_recompute: the result is not in the map's "
                    "dtype")
            diff = (got.float() - want.float()).abs()
            tol = 1e-5 * mass + 1e-6
            if dtype == torch.bfloat16:
                tol = tol + 2.0 ** -7 * want.float().abs()
            errs[dtype] = float(diff.max())
            log(f"kernel roi_pool_bwd_recompute {str(dtype)[6:]} map {label}: "
                f"max |diff| {errs[dtype]:.3e}, worst diff/tol "
                f"{float((diff / tol).max()):.3f}, zero cells of the map "
                f"{float((feats32 == 0).float().mean()):.2f}")
            require(bool((diff <= tol).all()),
                    f"roi_pool_bwd_recompute {dtype} {label} outside tolerance")
            require(bool((got != 0).any()),
                    "roi_pool_bwd_recompute wrote nothing")
        del diff, tol, want, got

        feats = feats32.to(torch.bfloat16)       # the train path's dtype
        nbytes6 = (feats.numel() * 2 * 2 + rois.numel() * 4 + g.numel() * 4)
        ops6 = bin_pixels(rois, h, w) * c + g.numel()
        ms6 = cuda_time_ms(lambda: roi_pool_bwd_recompute(feats, rois, g), 20)
        plain6 = cuda_time_ms(
            lambda: roi_pool_grad_first_argmax(feats, rois, g), 1, warmup=1)
        t_bytes, t_ops = nbytes6 / HBM_BYTES_PER_S, ops6 / F32_FLOP_PER_S
        bound6 = max(t_bytes, t_ops) * 1e3
        by6 = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel roi_pool_bwd_recompute bf16 {label}: {ms6:.4f} ms, "
            f"plain {plain6:.3f} ms, bound {bound6:.5f} ms ({by6}: "
            f"{nbytes6 / 1e6:.1f} MB, {ops6 / 1e9:.2f} G compares and adds)")

        # 5b: index, cotangent read once, the f32 map written once; one add
        # per element.  Its library yardstick is one index_add_ over the
        # flattened map with the flat indices made beforehand (empty bins
        # sent to one extra cell).
        nbytes = argmax.numel() * 8 + b * h * w * c * 4
        ops = argmax.numel()
        ms = cuda_time_ms(lambda: roi_pool_bwd_scatter(argmax, g, h, w), 20)
        plain_ms = cuda_time_ms(lambda: scatter_argmax_grad(argmax, g, h, w),
                                5, warmup=1)
        idx = argmax.reshape(b, -1, c).long()
        flat = ((torch.arange(b, device=dev)[:, None, None] * (h * w) + idx)
                * c + torch.arange(c, device=dev))
        flat = torch.where(idx < 0, b * h * w * c, flat).reshape(-1)
        gflat = g.reshape(-1)
        lib = torch.zeros(b * h * w * c + 1, device=dev).index_add_(0, flat,
                                                                   gflat)
        lib_err = float((lib[:-1].reshape(b, h, w, c)
                         - scatter_argmax_grad(argmax, g, h, w)).abs().max())
        require(lib_err <= 1e-2, f"the index_add_ yardstick computes "
                f"something else ({lib_err})")
        del lib
        library_ms = cuda_time_ms(lambda: torch.zeros(
            b * h * w * c + 1, device=dev).index_add_(0, flat, gflat), 5,
            warmup=1)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel roi_pool_bwd_scatter {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB)")
        shapes[label] = dict(
            plans=plans, recompute=dict(
                ms=ms6, plain_ms=plain6, bound_ms=bound6, bound_by=by6,
                bytes=nbytes6, max_abs_err={str(k)[6:]: v
                                            for k, v in errs.items()}),
            scatter=dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         max_abs_err=err_scatter))
        if route != "slice":
            continue
        rows.append(dict(
            name="roi_pool_bwd_recompute", route="cuda",
            source="two_stage_object_detection_tpu_torch/csrc/roi_pool_bwd.cu",
            replaces="two_stage_object_detection_tpu/ops/pallas_roi_bwd.py:42",
            max_abs_err=max(errs.values()), ms=ms6, plain_ms=plain6,
            bound_ms=bound6, bound_by=by6, library_ms=None))
        rows.append(dict(
            name="roi_pool_bwd_scatter", route="cuda",
            source="two_stage_object_detection_tpu_torch/csrc/roi_pool_bwd.cu",
            replaces="two_stage_object_detection_tpu/ops/pallas_roi.py:151",
            max_abs_err=err_scatter, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        del feats32, feats, rois, g, argmax, mass, flat, gflat
        torch.cuda.empty_cache()
    return rows, shapes


# ------------------------------------------------- kernels 1 and 3, chunks
# above the rows one walk launch holds (112,128): (rows, case) at B=2, n_post
# 300; "crossing": the best rows are near-duplicates of 6 boxes, so the
# walk's first chunk keeps at most 6 and the kept set crosses into later
# chunks; "first_chunk": the first chunk fills n_post
ABOVE_CAP = ((112129, "first_chunk"), (112129, "crossing"),
             (250000, "first_chunk"), (250000, "crossing"))


def crowded(rng, b: int, n: int, frac: float):
    """``n`` random boxes of 16..216 px over a 600 px image and scores in
    [0, 0.5), except the best ``frac`` of the rows: 1 px jitters of 6 boxes
    of 100 px (each kept one suppresses the rest) scoring [0.5, 1); every
    8th row's score masked (-1e9).  ``[b, n, 4]``, ``[b, n]`` f32 numpy."""
    xy = rng.rand(b, n, 2) * 400.0
    boxes = np.concatenate([xy, xy + rng.rand(b, n, 2) * 200.0 + 16.0], -1)
    scores = rng.rand(b, n) * 0.5
    n_dup = int(frac * n)
    base = rng.rand(b, 6, 2) * 400.0
    pick = np.take_along_axis(base, rng.randint(0, 6, (b, n_dup))[..., None], 1)
    boxes[:, :n_dup] = (np.concatenate([pick, pick + 100.0], -1)
                        + rng.rand(b, n_dup, 4))
    scores[:, :n_dup] += 0.5
    scores[:, 7::8] = -1e9
    return boxes.astype(np.float32), scores.astype(np.float32)


def check_above_cap(rng, dev):
    """Kernels 1 and 3 above the rows one launch of the walk holds, B=2,
    n_post 300, bit for bit against their plain versions, timed: kernel 1 on
    score-sorted rows, kernel 3 on anchors decoded with zero offsets (so its
    boxes are the anchors).  Returns each shape's numbers."""
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        _decode_masked, fused_proposals_batched, fused_proposals_rows_reference,
        greedy_nms, greedy_nms_rows_reference, nms_chunks,
        sorted_rows_reference)
    b, n_post, img = 2, 300, (600, 600)
    kw = dict(nms_iou=0.7, n_post_nms=n_post, min_size=16.0)
    shapes = {}
    for k, case in ABOVE_CAP:
        frac = 0.7 if case == "crossing" else 0.0
        boxes, scores = crowded(rng, b, k, frac)
        rows0 = nms_chunks(k)[0][1]
        # kernel 3: the rows are anchors, decoded with zero offsets
        anchors = torch.from_numpy(boxes[0]).to(dev)
        locs = torch.zeros((b, k, 4), device=dev)
        fg = torch.from_numpy(scores).to(dev)
        order = np.argsort(-scores, axis=1, kind="stable")
        s_boxes = torch.from_numpy(np.take_along_axis(
            np.broadcast_to(boxes[:1], boxes.shape), order[..., None], 1)).to(dev)
        s_scores = torch.from_numpy(np.take_along_axis(scores, order, 1)).to(dev)
        for name, run, plain, first_rows in (
                ("greedy_nms",
                 lambda: greedy_nms(s_boxes, s_scores, n_post=n_post,  # noqa: E731
                                    iou_threshold=0.7),
                 lambda: greedy_nms_rows_reference(             # noqa: E731
                     s_boxes, s_scores, n_post=n_post, iou_threshold=0.7),
                 lambda: (s_boxes, s_scores)),                  # noqa: E731
                ("fused_proposals_batched",
                 lambda: fused_proposals_batched(locs, fg, anchors, img,  # noqa: E731
                                                 **kw),
                 lambda: fused_proposals_rows_reference(        # noqa: E731
                     locs, fg, anchors, img, **kw),
                 lambda: sorted_rows_reference(*_decode_masked(  # noqa: E731
                     locs, fg, anchors, img, 16.0)))):
            got, want = run(), plain()
            torch.cuda.synchronize()
            n_diff = sum(int((g != w).sum()) for g, w in zip(got, want))
            fb, fs = first_rows()
            first = greedy_nms_rows_reference(
                fb[:, :rows0], fs[:, :rows0], n_post=n_post,
                iou_threshold=0.7)[2].sum(1).tolist()
            kept = got[2].sum(1).tolist()
            ms = cuda_time_ms(run, 5)
            log(f"kernel {name} B={b} rows={k} n_post={n_post} ({case}, "
                f"{len(nms_chunks(k))} walk launches): {n_diff} elements "
                f"differ from plain; kept {kept}, the first chunk alone "
                f"{first}; {ms:.4f} ms")
            require(n_diff == 0, f"{name} rows={k} {case}: outputs differ from "
                    "the plain version (must be bitwise equal)")
            require(min(kept) == n_post, f"{name} rows={k}: kept fewer than "
                    "n_post")
            if case == "crossing":
                require(max(first) <= 6, f"{name} rows={k}: the first chunk "
                        "is not crowded")
            else:
                require(min(first) == n_post, f"{name} rows={k}: the first "
                        "chunk does not fill n_post")
            shapes[f"{name} rows{k} {case}"] = dict(
                ms=ms, kept=kept, first_chunk_kept=first,
                walk_launches=len(nms_chunks(k)))
        del locs, fg, anchors, s_boxes, s_scores
        torch.cuda.empty_cache()
    return shapes


# ------------------------------------------------------------ main path
def check_outputs(out, n: int, cfg):
    d = cfg.max_detections
    shapes = {"boxes": (n, d, 4), "scores": (n, d), "labels": (n, d),
              "valid": (n, d)}
    for name, shape in shapes.items():
        require(out[name].shape == shape, f"{name} shape {out[name].shape}")
    for name in ("boxes", "scores"):
        require(bool(np.isfinite(out[name]).all()), f"{name} not finite")
    v = out["valid"]
    require(bool((out["scores"][v] >= np.float32(cfg.score_thresh)).all()),
            "a valid detection scores below score_thresh")
    require(bool(((out["labels"][v] >= 1) & (out["labels"][v] <= cfg.num_classes)).all()),
            "a valid detection has a label outside 1..num_classes")
    require(bool((out["boxes"][~v] == 0).all() and (out["scores"][~v] == 0).all()),
            "invalid slots are not zeroed")
    return int(v.sum())


def counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        fused_proposals, fused_proposals_batched, greedy_nms)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
        roi_pool_bwd_recompute)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_bwd_scatter, roi_pool_max)
    from two_stage_object_detection_tpu_torch.ops.windowed_align import (
        windowed_roi_align_batched)
    return {"greedy_nms": greedy_nms,
            "windowed_align": windowed_roi_align_batched,
            "fused_proposals_batched": fused_proposals_batched,
            "fused_proposals": fused_proposals, "roi_pool_max": roi_pool_max,
            "roi_pool_bwd_recompute": roi_pool_bwd_recompute,
            "roi_pool_bwd_scatter": roi_pool_bwd_scatter}


# images per request, by wire: a padded bucket (3 -> 8), the full bucket
# and the one-image bucket
SERVE_REQUESTS = {"f32": (1, 3, 16), "u8": (16,)}


def serve(cfg, rng, label: str, expect):
    """A main path: a Predictor on ``cfg`` answering 1-, 3- and 16-image
    requests on the f32 wire and a 16-image one on the u8 wire, with every
    launch counter set to 0
    just before and read just after; each kernel in ``expect`` must have
    launched."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    from two_stage_object_detection_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    model = FasterRCNN(cfg, seed=0)
    log(f"{label} model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    h, w = cfg.input_size
    images = rng.rand(16, h, w, 3).astype(np.float32)
    servers = {wire: Predictor(cfg, model, batch_sizes=(1, 8, 16), wire=wire)
               for wire in ("f32", "u8")}
    # warm cuDNN's algorithm choice for every bucket outside the counted run
    for b in (1, 8, 16):
        model.predict(torch.from_numpy(images[:b]).to(model.device))
    torch.cuda.synchronize()

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    detections = {}
    for wire, server in servers.items():
        for n in SERVE_REQUESTS[wire]:
            req = images[:n] if wire == "f32" else np.round(
                images[:n] * 255).astype(np.uint8)
            out = server(req)
            detections[f"{wire}_{n}"] = check_outputs(out, n, cfg)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"{label} Predictor answered {SERVE_REQUESTS} requests; valid "
        f"detections {detections}; kernel launches {launches}")
    for name in expect:
        require(launches[name] > 0, f"the {label} path never launched {name}")
    # with random heads every class may score under score_thresh: the
    # proposals, at least, must be there
    x16 = torch.from_numpy(images).to(model.device)
    with torch.inference_mode():
        feats = model.features(x16)
        n_prop = int(model.proposals(*model.rpn_head(feats), (h, w))[2].sum())
    del feats
    log(f"{label} b=16: {n_prop} valid proposals of "
        f"{16 * cfg.n_test_post_nms}")
    require(n_prop > 0, f"the {label} path made no valid proposal")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: model.predict(x16), 10)
    peak = torch.cuda.max_memory_allocated()
    req = np.round(images * 255).astype(np.uint8)
    t0 = time.perf_counter()
    for _ in range(3):
        servers["u8"](req)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    perf = {"predict_b16_ms": ms, "predict_b16_img_per_s": 16e3 / ms,
            "predictor_u8_b16_ms": host_ms,
            "predictor_u8_b16_img_per_s": 16e3 / host_ms,
            "peak_mem_gb": peak / 1e9, "stages_ms": stage_times(model, x16)}
    log(f"{label} predict b=16: {ms:.2f} ms/batch = {16e3 / ms:.1f} img/s on "
        f"the device (CUDA events); Predictor u8 end to end {host_ms:.2f} ms = "
        f"{16e3 / host_ms:.1f} img/s; peak memory {peak / 1e9:.2f} GB")
    log(f"{label} predict b=16 by stage, each timed alone (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in perf["stages_ms"].items()))
    return launches, detections, perf


@torch.inference_mode()
def stage_times(model, x):
    """Device time of each stage of the b=16 predict, each stage run alone
    on the previous stage's outputs; ``post_process`` is the rest of
    ``detect`` (softmax, per-class decode, top-k, class-offset NMS)."""
    img = tuple(x.shape[1:3])
    feats = model.features(x)
    rpn = model.rpn_head(feats)
    rois = model.proposals(*rpn, img)[0]
    t = {"backbone_neck": cuda_time_ms(lambda: model.features(x), 10),
         "rpn_head": cuda_time_ms(lambda: model.rpn_head(feats), 10),
         "proposals": cuda_time_ms(lambda: model.proposals(*rpn, img), 10),
         "roi_head": cuda_time_ms(lambda: model.roi_head(feats, rois, img), 10)}
    detect = cuda_time_ms(lambda: model.detect(feats, img), 10)
    t["post_process"] = detect - t["rpn_head"] - t["proposals"] - t["roi_head"]
    return t


FIELDS = ("boxes", "scores", "labels", "valid")


def outputs(res):
    """Predict's four output tensors as a dict of numpy arrays."""
    return dict(zip(FIELDS, (t.cpu().numpy() for t in res)))


def agree(a, b):
    """``(share, bitwise)`` of two outputs (dicts of the four fields): the
    share of the detection slots valid in either where both are valid with
    the same label, scores within 1e-4 and boxes within 1e-2 px (the f32
    parity's tolerances; near-tied candidates may swap), and whether every
    field is equal bit for bit."""
    same = ((a["valid"] == b["valid"]) & (a["labels"] == b["labels"])
            & (np.abs(a["scores"] - b["scores"]) <= 1e-4)
            & (np.abs(a["boxes"] - b["boxes"]).max(-1) <= 1e-2))
    either = a["valid"] | b["valid"]
    share = float(same[either].mean()) if either.any() else 1.0
    return share, all(np.array_equal(a[k], b[k]) for k in a)


def f32_parity(cfg, rng, label: str):
    """The same predict in float32 with TF32 off, through the kernels and
    with pallas="off", at b=2: equal proposals, close detections."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    torch.backends.cudnn.deterministic = True
    c32 = cfg.replace(compute_dtype="float32", score_thresh=0.0)
    on = FasterRCNN(c32, seed=1)
    off = FasterRCNN(c32.replace(pallas="off"), seed=1)
    h, w = cfg.input_size
    x = torch.from_numpy(rng.rand(2, h, w, 3).astype(np.float32)).to(on.device)
    with torch.inference_mode():
        feats = on.features(x)
        rpn = on.rpn_head(feats)
        p_on = on.proposals(*rpn, (h, w))
        p_off = off.proposals(*rpn, (h, w))
        for name, a, b in zip(("rois", "scores", "valid"), p_on, p_off):
            require(torch.equal(a, b), f"f32 proposals: {name} differ")
        head_on = on.roi_head(feats, p_on[0], (h, w))
        head_off = off.roi_head(feats, p_off[0], (h, w))
        d_on, d_off = on.detect(feats, (h, w)), off.detect(feats, (h, w))
    head_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))
                   for a, b in zip(head_on, head_off))
    frac, _ = agree(outputs(d_on), outputs(d_off))
    vv, wv = d_on[3].cpu().numpy(), d_off[3].cpu().numpy()
    log(f"{label} f32 (TF32 off) predict: proposals equal ({int(p_on[2].sum())} "
        f"valid); head outputs max rel diff {head_err:.2e} (tolerance 1e-4); "
        f"{int(vv.sum())}/{int(wv.sum())} detections, {frac:.3f} of slots "
        "agree (tolerance 0.95)")
    require(head_err <= 1e-4, "f32 head outputs differ beyond 1e-4")
    require(int(vv.sum()) > 0, "no f32 detections to compare")
    require(frac >= 0.95, "f32 detections differ")
    torch.backends.cudnn.deterministic = False
    return {"head_rel_err": head_err, "det_agree": frac}


# ------------------------------------------------------------ train paths
def train_batch(rng, cfg, b: int, wire: str = "u8"):
    """A synthetic padded batch from the seed: ``b`` images, 1..8 boxes each
    of 32..300 px inside the image, padded to ``cfg.max_gt_boxes``."""
    h, w = cfg.input_size
    g = cfg.max_gt_boxes
    image = rng.randint(0, 256, size=(b, h, w, 3)).astype(np.uint8)
    if wire == "f32":
        image = image.astype(np.float32) / np.float32(255.0)
    side = rng.uniform(32.0, 300.0, size=(b, g, 2))
    xy = rng.rand(b, g, 2) * (np.array([w, h]) - side)
    boxes = np.concatenate([xy, xy + side], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < rng.randint(1, 9, size=(b, 1))
    boxes[~valid] = 0.0
    labels = rng.randint(0, cfg.num_classes, size=(b, g)).astype(np.int64)
    return {"image": image, "boxes": boxes, "labels": labels, "valid": valid}


def snapshot(model):
    params = [p.detach().clone() for p in model.parameters()]
    stats = [b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return params, stats


def n_changed(model, snap):
    params, stats = snap
    now_p, now_s = snapshot(model)
    return (sum(int(not torch.equal(a, b)) for a, b in zip(params, now_p)),
            sum(int(not torch.equal(a, b)) for a, b in zip(stats, now_s)))


def train(cfg, rng, label: str, expect):
    """A train path: ``create_train_state`` and four ``train_step``
    micro-steps on ``cfg`` at batch 16 with ``grad_accum_steps=2`` (two
    optimiser updates), u8 images, random sampling from a generator, with
    every launch counter set to 0 just before and read just after."""
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    cfg = cfg.replace(grad_accum_steps=2)
    model, state = create_train_state(cfg, seed=0, steps_per_epoch=8)
    gen = torch.Generator(device=model.device).manual_seed(0)
    batches = [train_batch(rng, cfg, 16) for _ in range(4)]
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, changed = [], [], []
    for batch in batches:
        snap = snapshot(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
        changed.append(n_changed(model, snap))
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"{label} train: 4 micro-steps at b=16, grad_accum_steps=2: "
        f"{state.updates} updates; step ms {[round(t, 1) for t in step_ms]}; "
        f"peak memory {peak / 1e9:.2f} GB; kernel launches {launches}")
    for i, (ls, (n_p, n_s)) in enumerate(zip(losses, changed)):
        log(f"  micro-step {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in ls.items())
            + f"; {n_p} parameters and {n_s} running statistics changed")
        require(all(np.isfinite(v) for v in ls.values()),
                f"{label} train: a loss of micro-step {i} is not finite")
        require(n_s > 0, f"{label} train: micro-step {i} moved no running "
                "statistic")
        require((n_p > 0) == (i % 2 == 1), f"{label} train: parameters "
                f"{'did not move' if i % 2 else 'moved'} at micro-step {i}")
    require(state.updates == 2 and state.step == 4, "wrong update count")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"{label} train: a parameter is not finite after two updates")
    for name in expect:
        require(launches[name] > 0, f"the {label} train path never launched "
                f"{name}")
    # steps 2 and 3 run on a warm allocator and warm cuDNN plans
    perf = {"step_ms": step_ms, "warm_step_ms": float(np.mean(step_ms[2:])),
            "warm_img_per_s": 16e3 / float(np.mean(step_ms[2:])),
            "peak_mem_gb": peak / 1e9, "losses": losses,
            "stages_ms": train_stage_times(state, batches[0])}
    log(f"{label} train b=16: {perf['warm_step_ms']:.1f} ms a micro-step "
        f"(mean of the last two, host clock around a synchronised step) = "
        f"{perf['warm_img_per_s']:.1f} img/s")
    log(f"{label} train b=16 by stage, each timed alone (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in perf["stages_ms"].items()))
    return launches, perf


def train_stage_times(state, batch):
    """Device time of the pieces of one b=16 train micro-step, each run
    alone on the previous piece's outputs (train-mode batch norm, first-k
    sampling): the forward pieces without a graph, then the whole
    ``train_forward`` with its graph plus the backward pass, and one AdamW
    update on the gradients that leaves."""
    from two_stage_object_detection_tpu_torch.nets.targets import (
        anchor_target, proposal_target)
    model, cfg = state.model, state.cfg
    b = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    x = b["image"].float() / 255.0
    img = tuple(x.shape[1:3])
    model.set_mode(True)
    with torch.no_grad():
        feats = model.features(x)
        rpn = model.rpn_head(feats)
        rois, _, roi_valid = model.proposals(*rpn, img, 1.0, True)
        sample_roi = proposal_target(rois, roi_valid, b["boxes"], b["valid"],
                                     b["labels"], n_sample=cfg.roi_n_sample)[0]
        head = ((lambda: model.roi_head(feats, sample_roi, img, use_window=False))
                if cfg.fpn else (lambda: model.roi_head(feats, sample_roi, img)))
        t = {"backbone_neck": cuda_time_ms(lambda: model.features(x), 5),
             "rpn_head": cuda_time_ms(lambda: model.rpn_head(feats), 5),
             "proposals": cuda_time_ms(
                 lambda: model.proposals(*rpn, img, 1.0, True), 5),
             "anchor_target": cuda_time_ms(lambda: anchor_target(
                 model.anchors, b["boxes"], b["valid"],
                 n_sample=cfg.rpn_n_sample), 5),
             "proposal_target": cuda_time_ms(lambda: proposal_target(
                 rois, roi_valid, b["boxes"], b["valid"], b["labels"],
                 n_sample=cfg.roi_n_sample), 5),
             "roi_head": cuda_time_ms(head, 5)}

    def forward_backward():
        model.zero_grad(set_to_none=True)
        model.train_forward(x, b["boxes"], b["labels"],
                            b["valid"])["losses"]["total"].backward()

    t["forward_backward"] = cuda_time_ms(forward_backward, 3, warmup=1)
    t["adamw_update"] = cuda_time_ms(state.optimizer.step, 3, warmup=1)
    model.zero_grad(set_to_none=True)
    return t


def grads_of(model, batch):
    model.zero_grad(set_to_none=True)
    b = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    out = model.train_forward(b["image"], b["boxes"], b["labels"], b["valid"])
    out["losses"]["total"].backward()
    return ({k: float(v.detach()) for k, v in out["losses"].items()},
            {n: p.grad for n, p in model.named_parameters()})


RELU_MARGIN = 1e-4


def relu_sites(model):
    """The box head's layers whose outputs go through a ReLU (the flagship's
    fc1 and fc2; the single-scale head has none)."""
    return [m for n, m in model.roi_head.named_children() if n in ("fc1", "fc2")]


@torch.no_grad()
def settle_relus(model, batch):
    """One train-mode forward that shifts, feature by feature, the bias of
    every layer of ``relu_sites`` until none of its outputs lies within
    ``RELU_MARGIN`` of 0, the ReLU's threshold.  Returns how many features it
    shifted."""
    moved = [0]

    def clear(layer, _, out):
        v = out.reshape(-1, out.shape[-1]).double()
        shift = torch.zeros(v.shape[1], dtype=v.dtype, device=v.device)
        todo = v.abs().amin(0) < RELU_MARGIN
        moved[0] += int(todo.sum())
        k = 0
        while bool(todo.any()):
            k += 1
            require(k < 1000, "no shift clears a ReLU's threshold")
            for step in (0.5 * k * RELU_MARGIN, -0.5 * k * RELU_MARGIN):
                cand = torch.where(todo, torch.full_like(shift, step), shift)
                found = todo & ((v + cand).abs().amin(0) >= RELU_MARGIN)
                shift = torch.where(found, cand, shift)
                todo = todo & ~found
        layer.bias.add_(shift.to(layer.bias.dtype))
        return out + shift.to(out.dtype)

    hooks = [m.register_forward_hook(clear) for m in relu_sites(model)]
    b = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    model.train_forward(b["image"], b["boxes"], b["labels"], b["valid"])
    for h in hooks:
        h.remove()
    return moved[0]


def grads_and_masks(model, batch):
    """``grads_of`` plus, for each layer of ``relu_sites``, which of its
    outputs were above 0."""
    masks = []
    hooks = [m.register_forward_hook(lambda _m, _i, out: masks.append(out > 0))
             for m in relu_sites(model)]
    losses, grads = grads_of(model, batch)
    for h in hooks:
        h.remove()
    return losses, grads, masks


def train_parity(cfg, rng, label: str):
    """One float32 ``train_forward`` + backward at b=2, TF32 off, through
    the kernels and with pallas="off" (the plain versions), same weights,
    batch and first-k sampling: the losses within 1e-6 (of the loss where it
    is above 1: one f32 ulp of a loss of 9 is 9.5e-7), every gradient leaf
    within 1e-4 of the leaf's largest magnitude plus 1e-4 of the model's
    largest gradient magnitude.  The second term is the floor for leaves
    whose gradient is a sum that cancels: one whose true gradient is zero
    and whose computed one is f32 rounding noise (a batch-norm bias that
    only feeds 1x1 convs followed by train-mode batch norm, which removes
    any constant shift), or a PReLU slope, one number a thousandth of the
    model's largest gradient.

    The two forward passes are bit-equal on the single scale (kernels 3 and
    5 equal their plain versions; only kernel 6's atomic adds reorder sums
    in the backward pass).  The flagship's kernel 2 differs from its plain
    version by f32 summation order (7e-7), so a ReLU unit of fc1 or fc2
    whose input lies that close to 0 can take another side, a step in the
    gradients.  The comparison is therefore made twice: on the seed's
    weights as they come, where the units that differ are counted and the
    worst leaf is printed and held to nothing, and on weights whose fc
    biases ``settle_relus`` has moved off the threshold, where the ReLU
    masks must be equal and the leaves within the tolerance."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    torch.backends.cudnn.deterministic = True
    c32 = cfg.replace(compute_dtype="float32")
    batch = train_batch(rng, c32, 2, wire="f32")
    on = FasterRCNN(c32, seed=1)
    off = FasterRCNN(c32.replace(pallas="off"), seed=1)
    result = {}
    for weights in ("seeded", "settled") if relu_sites(off) else ("seeded",):
        if weights == "settled":
            result["features_shifted"] = settle_relus(off, batch)
            on.load_state_dict(off.state_dict())
        l_on, g_on, m_on = grads_and_masks(on, batch)
        l_off, g_off, m_off = grads_and_masks(off, batch)
        flips = sum(int((a != b).sum()) for a, b in zip(m_on, m_off))
        units = sum(a.numel() for a in m_on)
        loss_err = max(abs(l_on[k] - l_off[k]) / max(1.0, abs(l_off[k]))
                       for k in l_on)
        for name, g in g_off.items():
            require(g is not None and g_on[name] is not None,
                    f"{label}: {name} got no gradient")
        top = max(float(g.abs().max()) for g in g_off.values())
        ratios = []
        for name, g in g_off.items():
            err = float((g_on[name] - g).abs().max())
            leaf = float(g.abs().max())
            ratios.append((err / (1e-4 * leaf + 1e-4 * top),
                           err / max(leaf, 1e-30), name))
        ratios.sort(reverse=True)
        worst, _, where = ratios[0]
        log(f"{label} f32 (TF32 off) train_forward + backward, kernels on vs "
            f"off, b=2, {weights} weights: losses {l_on}; max |loss diff| "
            f"{loss_err:.2e} (tolerance 1e-6 * max(1, |loss|)); {flips} of "
            f"{units} ReLU units of the box head differ; worst gradient leaf "
            f"{where} at {worst:.3f} of its tolerance (1e-4 of the leaf's "
            f"largest magnitude + 1e-4 of the model's, {top:.3e}); "
            f"{len(g_off)} leaves; the three worst (share of tolerance, "
            "share of leaf): "
            + ", ".join(f"{n} {a:.3f} {b:.2e}" for a, b, n in ratios[:3]))
        require(loss_err <= 1e-6, f"{label}: f32 losses differ by {loss_err}")
        result[weights] = {"loss_err": loss_err, "grad_err_over_tol": worst,
                           "relu_flips": flips, "relu_units": units}
    torch.backends.cudnn.deterministic = False
    require(flips == 0, f"{label}: {flips} ReLU units differ on {weights} "
            "weights")
    require(worst <= 1.0, f"{label}: f32 gradient {where} is at {worst} of "
            "its tolerance")
    return result


def train_modes(cfg, rng):
    """Two micro-steps at b=2 on each plain backward route of the
    single-scale RoI head, to show that it runs on the card: finite losses
    and parameters.  These are side routes at a small batch: their launches
    are printed here and do not enter the kernels line.  The first step of a
    route pays its one-time costs (cuDNN plans for the new batch size, the
    first call of its operators); the second is the route's own time."""
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    times, launched = {}, {}
    for mode in ("xla", "structured"):
        c = cfg.replace(grad_accum_steps=2, roi_bwd=mode)
        model, state = create_train_state(c, seed=0)
        batch = train_batch(rng, c, 2)
        wrappers = counters()
        for fn in wrappers.values():
            fn.launches = 0
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = train_step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            require(bool(torch.isfinite(losses["total"])),
                    f"train roi_bwd={mode}: the loss is not finite")
        require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                f"train roi_bwd={mode}: a parameter is not finite after the "
                "update")
        launched[mode] = {n: f.launches for n, f in wrappers.items()
                          if f.launches}
        require("roi_pool_bwd_recompute" not in launched[mode]
                and "roi_pool_bwd_scatter" not in launched[mode],
                f"roi_bwd={mode} launched a backward kernel")
        log(f"single-scale train roi_bwd={mode} b=2 (a side route, not in "
            f"the kernels line): two micro-steps in {ms[0]:.0f} and "
            f"{ms[1]:.0f} ms, total loss {float(losses['total']):.4f}, "
            f"launches {launched[mode]}")
        times[mode] = ms
    return launched, times


# ------------------------------------------------------------ drivers
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "real_coco")
DRIVER_IMAGES = {"train2017": 32, "val2017": 16}
# the timed loop: 8 micro-steps at b=16 an epoch, so that the first batch's
# fill is an eighth of the epoch and not a half
LONG_IMAGES = {"train2017": 128, "val2017": 16}
# the drivers' --set overrides, shared by the CLI runs and the loader alone
DRIVER_SETS = ["batch_size=16", "grad_accum_steps=2", "num_epochs=2",
               "train_ratio=1.0", "eval_ratio=1.0"]


def driver_data_root(root: str, counts=DRIVER_IMAGES) -> str:
    """A COCO-layout root over the three committed JPEGs of
    ``tests/data/real_coco``: each split lists them again and again under
    distinct image ids (``counts`` a split), and its image folder links to
    the fixture's."""
    with open(os.path.join(FIXTURE, "annotations",
                           "instances_train2017.json")) as f:
        base = json.load(f)
    os.makedirs(os.path.join(root, "annotations"))
    for split, n in counts.items():
        images, anns = [], []
        for k in range(n):
            img = base["images"][k % len(base["images"])]
            images.append({**img, "id": k + 1})
            anns += [{**a, "id": len(anns) + 1, "image_id": k + 1}
                     for a in base["annotations"] if a["image_id"] == img["id"]]
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": base["categories"]}, f)
        os.symlink(os.path.join(FIXTURE, "train2017"),
                   os.path.join(root, split))
    return root


class Records(logging.Handler):
    """Keeps the log records of the port's drivers that carry ``seconds``
    (the train loop's epochs, the eval passes) or ``cache_bytes`` (a
    dataset placed on the card)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if hasattr(record, "seconds") or hasattr(record, "cache_bytes"):
            self.records.append(record)


def run_cli(argv):
    """``__main__.main(argv)`` in this process; returns what it printed."""
    import contextlib
    import io

    from two_stage_object_detection_tpu_torch.__main__ import main as cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    require(rc == 0, f"{argv[0]} exited {rc}")
    return out.getvalue()


def loader_alone(root: str):
    """The train loader of the drivers' CLI runs alone (decode,
    augmentation, pinned copies to the card; no train step), in each worker
    mode, over the long root: images per second over its first epoch (it
    starts the workers and fills the first batch) and over its second."""
    from two_stage_object_detection_tpu_torch.__main__ import _load_cfg
    from two_stage_object_detection_tpu_torch.train import build_loaders

    rates = {}
    for mode in ("thread", "process"):
        c = _load_cfg(argparse.Namespace(
            config=None, flagship=True,
            set=[*DRIVER_SETS, f"worker_mode={mode}"]))
        train_loader, eval_loader, _ = build_loaders(c, root)
        rates[mode] = []
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                n = sum(b["image"].shape[0] for b in train_loader)
                torch.cuda.synchronize()
                rates[mode].append(n / (time.perf_counter() - t0))
        finally:
            train_loader.close()
            eval_loader.close()
    log(f"drivers host pipeline alone (the train loader, {c.num_workers} "
        f"workers on {os.cpu_count()} cores, {n // c.batch_size} "
        f"{c.batch_size}-image batches an epoch to the card): " + ", ".join(
            f"{m} workers {r[1]:.1f} img/s in epoch 2 (epoch 1: {r[0]:.1f})"
            for m, r in rates.items()))
    return {m: {"epoch_1": r[0], "epoch_2": r[1]} for m, r in rates.items()}


def drivers(cfg, smi: str, bare_step_ms: float):
    """The drivers phase, on the flagship at full width: ``train`` (two
    epochs of 32 images at b=16, ``grad_accum_steps=2``, an eval sweep after
    each) through the CLI over the host pipeline, with every launch counter
    set to 0 just before and read just after; then ``eval`` of the best
    checkpoint in both protocols, and a ``Predictor`` from it serving one
    3-image u8 request."""
    import tempfile

    from two_stage_object_detection_tpu_torch.data import native
    from two_stage_object_detection_tpu_torch.data.coco import load_coco
    from two_stage_object_detection_tpu_torch.data.pipeline import (
        DetectionDataset, DevicePut)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.serving import Predictor
    from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    records = Records()
    logging.getLogger("two_stage_object_detection_tpu_torch").addHandler(records)
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    decoder = ("native (native/preprocess.cpp, libjpeg/libpng)"
               if native.available() else pil)
    log(f"drivers: decoder: {decoder}")
    log(f"drivers: Loader copy scheme: {DevicePut.scheme}")
    wrappers = counters()
    out = {"decoder": decoder, "copy_scheme": DevicePut.scheme}
    with tempfile.TemporaryDirectory() as tmp:
        root = driver_data_root(os.path.join(tmp, "data"))
        weights = os.path.join(tmp, "weights")
        sets = [a for kv in DRIVER_SETS for a in ("--set", kv)]
        common = ["--flagship", "--data-root", root, "--weights", weights,
                  *sets]
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        run_cli(["train", *common, "--eval-period", "1", "--no-viz"])
        train_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        epochs = [r for r in records.records if hasattr(r, "epoch")]
        require(len(epochs) == 2, f"{len(epochs)} epochs logged, not 2")
        for r in epochs:
            require(bool(np.isfinite(r.loss)), f"epoch {r.epoch}: loss {r.loss}")
        for name in (ckpt.BEST, ckpt.LAST):
            require(os.path.exists(os.path.join(weights, name, ckpt.STATE_FILE)),
                    f"train wrote no {name}")
        with open(os.path.join(weights, "train_meta.json")) as f:
            best_loss = json.load(f)["min_eval_loss"]
        require(bool(np.isfinite(best_loss)), f"best eval loss {best_loss}")
        for name in ("greedy_nms", "windowed_align"):
            require(launches[name] > 0, f"the drivers' train never launched "
                    f"{name}")
        _, state = create_train_state(cfg, seed=0)
        require(ckpt.restore_checkpoint(weights, state, name=ckpt.LAST)
                is not None, "LAST does not restore")
        require(state.step == 4 and state.updates == 2,
                f"LAST holds step {state.step}, updates {state.updates}")
        del state
        e2 = epochs[1]
        loop_step_ms = e2.seconds / e2.micro_steps * 1e3
        log(f"drivers train (flagship, 600x600, b=16, grad_accum_steps=2, 2 "
            f"epochs of {DRIVER_IMAGES['train2017']} images, an eval of "
            f"{DRIVER_IMAGES['val2017']} after each): {train_s:.1f} s in all; "
            f"mean losses {[round(r.loss, 4) for r in epochs]}; best eval "
            f"loss {best_loss:.4f}; kernel launches {launches}")
        log(f"drivers train loop, epoch 2: {e2.images / e2.seconds:.1f} img/s "
            f"({e2.images} images in {e2.seconds:.3f} s, host pipeline and "
            f"copies included); {loop_step_ms:.1f} ms a micro-step inside the "
            f"loop against {bare_step_ms:.1f} ms for the bare b=16 micro-step "
            f"of the train phase (epoch 1: {e2.images / epochs[0].seconds:.1f}"
            " img/s)")
        out.update(train_s=train_s, launches_train=launches,
                   epoch_s=[r.seconds for r in epochs],
                   epoch_loss=[r.loss for r in epochs],
                   loop_img_per_s=e2.images / e2.seconds,
                   loop_step_ms=loop_step_ms, bare_step_ms=bare_step_ms,
                   best_eval_loss=best_loss)

        # the timed loop: the same train over 128 images, an eval of 16
        # after epoch 1 only; then its loader alone
        long_root = driver_data_root(os.path.join(tmp, "long"), LONG_IMAGES)
        n = len(records.records)
        run_cli(["train", "--flagship", "--data-root", long_root, "--weights",
                 os.path.join(tmp, "long_weights"), *sets,
                 "--eval-period", "100", "--no-viz"])
        long = [r for r in records.records[n:] if hasattr(r, "epoch")]
        require(len(long) == 2 and all(np.isfinite(r.loss) for r in long),
                f"the long train logged {[(r.epoch, r.loss) for r in long]}")
        l2 = long[1]
        long_step_ms = l2.seconds / l2.micro_steps * 1e3
        log(f"drivers train loop, long root, epoch 2: "
            f"{l2.images / l2.seconds:.1f} img/s ({l2.micro_steps} micro-steps"
            f", {l2.images} images in {l2.seconds:.3f} s); {long_step_ms:.1f} "
            f"ms a micro-step against {bare_step_ms:.1f} ms bare (epoch 1: "
            f"{long[0].images / long[0].seconds:.1f} img/s)")
        out.update(long_epoch_s=[r.seconds for r in long],
                   long_micro_steps=[r.micro_steps for r in long],
                   long_loop_img_per_s=l2.images / l2.seconds,
                   long_loop_step_ms=long_step_ms)
        out["loader_alone_img_per_s"] = loader_alone(long_root)

        out["eval"] = {}
        for flag, protocol in (([], "train-graph"), (["--predict"], "predict")):
            for fn in wrappers.values():
                fn.launches = 0
            n = len(records.records)
            sweep = json.loads(run_cli(["eval", *common, "--checkpoint", "best",
                                        *flag]))
            seconds = [r.seconds for r in records.records[n:]
                       if getattr(r, "protocol", None) == protocol]
            require(len(seconds) == 1, f"eval {protocol}: no timing record")
            vals = [sweep[k] for k in ("mAP50", "mAP95", "mAP50_95")]
            require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals),
                    f"eval {protocol}: mAPs {vals}")
            require(bool(np.isfinite(sweep["eval_loss"])),
                    f"eval {protocol}: eval_loss {sweep['eval_loss']}")
            ev_launch = {k: f.launches for k, f in wrappers.items() if f.launches}
            require(ev_launch.get("greedy_nms", 0) > 0
                    and ev_launch.get("windowed_align", 0) > 0,
                    f"eval {protocol} did not launch kernels 1 and 2")
            log(f"drivers eval --checkpoint best ({protocol}): {sweep}; the "
                f"pass over {DRIVER_IMAGES['val2017']} images took "
                f"{seconds[0]:.3f} s; kernel launches {ev_launch}")
            out["eval"][protocol] = {**sweep, "seconds": seconds[0],
                                     "launches": ev_launch}

        pred = Predictor.from_checkpoint(weights, cfg, wire="u8")
        idx = load_coco(os.path.join(root, "annotations",
                                     "instances_val2017.json"),
                        os.path.join(root, "val2017"), seed=None)
        ds = DetectionDataset(idx, cfg.input_size, train=False,
                              uint8_images=True)
        request = np.stack([ds[i]["image"] for i in range(3)])
        det = pred(request)
        n_det = check_outputs(det, 3, cfg)
        log(f"drivers Predictor.from_checkpoint (best) answered a 3-image u8 "
            f"request: {n_det} valid detections")
        out["predictor_detections"] = n_det
    logging.getLogger("two_stage_object_detection_tpu_torch").removeHandler(
        records)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"drivers phase: {out['phase_s']:.1f} s in all; card: {smi}")
    return out


# ------------------------------------------------------------ RoI routes
def cpu_parity(cfg, rng, label: str):
    """The route's f32 predict with TF32 off on the card against the same
    model on the CPU, from the card's features at b=2 (the backbone is not
    the route): the proposals, the box head on the card's rois and the
    detections, with the tolerances of :func:`f32_parity`."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    torch.backends.cudnn.deterministic = True
    c32 = cfg.replace(compute_dtype="float32", score_thresh=0.0)
    gpu = FasterRCNN(c32, seed=1)
    cpu = FasterRCNN(c32, device="cpu", seed=1)
    h, w = cfg.input_size
    x = torch.from_numpy(rng.rand(2, h, w, 3).astype(np.float32)).to(gpu.device)
    with torch.inference_mode():
        feats = gpu.features(x)
        feats_c = (tuple(f.cpu() for f in feats) if isinstance(feats, tuple)
                   else feats.cpu())
        rpn = gpu.rpn_head(feats)
        p_g = gpu.proposals(*rpn, (h, w))
        p_c = cpu.proposals(*(t.cpu() for t in rpn), (h, w))
        rows = ((p_g[2].cpu() == p_c[2])
                & ((p_g[0].cpu() - p_c[0]).abs().amax(-1) <= 1e-2))
        prop_agree = float(rows.float().mean())
        head_g = gpu.roi_head(feats, p_g[0], (h, w))
        head_c = cpu.roi_head(feats_c, p_g[0].cpu(), (h, w))
        d_g, d_c = gpu.detect(feats, (h, w)), cpu.detect(feats_c, (h, w))
    head_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-6))
                   for a, b in zip(head_g, head_c))
    vb, vs, vl, vv = (t.cpu().numpy() for t in d_g)
    wb, ws, wl, wv = (t.numpy() for t in d_c)
    same = ((vv == wv) & (vl == wl) & (np.abs(vs - ws) <= 1e-4)
            & (np.abs(vb - wb).max(-1) <= 1e-2))
    frac = float(same[wv | vv].mean()) if (wv | vv).any() else 1.0
    log(f"{label} f32 (TF32 off) card against CPU: {prop_agree:.4f} of "
        f"proposal rows agree (tolerance 0.95; {int(p_g[2].sum())} valid); "
        f"head outputs max rel diff {head_err:.2e} (tolerance 1e-4); "
        f"{int(vv.sum())}/{int(wv.sum())} detections, {frac:.3f} of slots "
        "agree (tolerance 0.95)")
    require(prop_agree >= 0.95, f"{label}: card and CPU proposals differ")
    require(head_err <= 1e-4, f"{label}: f32 head outputs differ beyond 1e-4")
    require(int(vv.sum()) > 0, f"{label}: no f32 detections to compare")
    require(frac >= 0.95, f"{label}: f32 detections differ")
    torch.backends.cudnn.deterministic = False
    return {"proposal_rows_agree": prop_agree, "head_rel_err": head_err,
            "det_agree": frac}


def roi_route(cfg, rng, label: str, expect, absent, kernel_roi_ms: float):
    """One RoI route at full width: a b=16 predict through a Predictor and
    two b=16 train micro-steps (``grad_accum_steps=2``), each with the
    counters set to 0 just before; the kernels in ``expect`` must launch in
    both, those in ``absent`` in neither; and :func:`cpu_parity`."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.serving import Predictor

    model = FasterRCNN(cfg, seed=0)
    h, w = cfg.input_size
    images = rng.rand(16, h, w, 3).astype(np.float32)
    x16 = torch.from_numpy(images).to(model.device)
    server = Predictor(cfg, model, batch_sizes=(16,), wire="f32")
    model.predict(x16)                       # cuDNN's choice, outside the count
    torch.cuda.synchronize()
    wrappers = counters()

    def launched(what):
        got = {name: fn.launches for name, fn in wrappers.items()}
        for name in expect:
            require(got[name] > 0, f"{label} {what} never launched {name}")
        for name in absent:
            require(got[name] == 0, f"{label} {what} launched {name}")
        return {k: v for k, v in got.items() if v}

    for fn in wrappers.values():
        fn.launches = 0
    n_det = check_outputs(server(images), 16, cfg)
    predict_launches = launched("predict")
    with torch.inference_mode():
        feats = model.features(x16)
        n_prop = int(model.proposals(*model.rpn_head(feats), (h, w))[2].sum())
    del feats
    require(0 < n_prop <= 16 * cfg.n_test_post_nms,
            f"{label}: {n_prop} valid proposals")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: model.predict(x16), 5)
    peak = torch.cuda.max_memory_allocated()
    stages = stage_times(model, x16)
    log(f"{label} predict b=16: {n_det} valid detections, {n_prop} valid "
        f"proposals of {16 * cfg.n_test_post_nms}; {ms:.2f} ms on the device; "
        f"peak memory {peak / 1e9:.2f} GB; kernel launches {predict_launches}")
    log(f"{label} predict b=16 by stage (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; roi_head {stages['roi_head']:.2f} against {kernel_roi_ms:.2f} "
        "on the kernel route of the same model")
    del model, server, x16
    torch.cuda.empty_cache()
    parity = cpu_parity(cfg, rng, label)
    torch.cuda.empty_cache()

    model, state = create_train_state(cfg.replace(grad_accum_steps=2), seed=0,
                                      steps_per_epoch=8)
    gen = torch.Generator(device=model.device).manual_seed(0)
    batches = [train_batch(rng, cfg, 16) for _ in range(2)]
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    snap = snapshot(model)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
        moved = n_changed(model, snap)[0]
        require(all(np.isfinite(v) for v in losses[-1].values()),
                f"{label} train: a loss of micro-step {i} is not finite")
        require((moved > 0) == (i == 1), f"{label} train: parameters "
                f"{'did not move' if i else 'moved'} at micro-step {i}")
    train_peak = torch.cuda.max_memory_allocated()
    train_launches = launched("train")
    require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            f"{label} train: a parameter is not finite")
    log(f"{label} train: 2 micro-steps at b=16 (one update); step ms "
        f"{[round(t, 1) for t in step_ms]}; total losses "
        f"{[round(v['total'], 4) for v in losses]}; peak memory "
        f"{train_peak / 1e9:.2f} GB; kernel launches {train_launches}")
    del model, state
    torch.cuda.empty_cache()
    return {"predict_b16_ms": ms, "peak_mem_gb": peak / 1e9, "stages_ms": stages,
            "kernel_route_roi_head_ms": kernel_roi_ms,
            "predict_launches": predict_launches, "detections": n_det,
            "proposals": n_prop, "cpu_parity": parity, "train_step_ms": step_ms,
            "train_losses": losses, "train_peak_mem_gb": train_peak / 1e9,
            "train_launches": train_launches}


# ------------------------------------------------------ device augmentation
def device_augment(rng):
    """``augment_batch`` at b=16, 600x600 on the card (CUDA events), and
    ``apply_augment`` of one record of draws on the card against the CPU."""
    from two_stage_object_detection_tpu_torch.data.device_transforms import (
        SCALES, apply_augment, augment_batch, draw_augment)
    cfg_img = 600
    images = torch.from_numpy(rng.rand(16, cfg_img, cfg_img, 3)
                              .astype(np.float32)).cuda()
    side = rng.uniform(32.0, 300.0, size=(16, 100, 2))
    xy = rng.rand(16, 100, 2) * (cfg_img - side)
    boxes = torch.from_numpy(np.concatenate([xy, xy + side], -1)
                             .astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = cuda_time_ms(lambda: augment_batch(images, boxes, gen), 10)
    draws = draw_augment(16, torch.Generator(device="cuda").manual_seed(1))
    gi, gb = apply_augment(images, boxes, draws)
    ci, cb = apply_augment(images.cpu(), boxes.cpu(),
                           {k: v.cpu() for k, v in draws.items()})
    err = float((gi.cpu() - ci).abs().max())
    scales = sorted({SCALES[int(j)] for j in draws["jitter"].cpu()})
    # two f32 matrix products an image, and each image read and written once
    flops = 2 * 16 * 2 * cfg_img ** 3 * 3
    bound_ms = max(2 * images.numel() * 4 / HBM_BYTES_PER_S,
                   flops / F32_FLOP_PER_S) * 1e3
    log(f"device augmentation: augment_batch b=16 600x600 {ms:.3f} ms (bound "
        f"{bound_ms:.3f} ms, the jitter's {flops / 1e9:.1f} GFLOP in f32); "
        f"card against CPU on one record of draws: images max abs diff "
        f"{err:.2e} (tolerance 1e-4), boxes equal; scales drawn {scales}")
    require(err <= 1e-4, f"augment_batch: card and CPU differ by {err}")
    require(torch.equal(gb.cpu(), cb), "augment_batch: boxes differ")
    require(bool(torch.isfinite(gi).all()), "augment_batch: not finite")
    return {"ms": ms, "bound_ms": bound_ms, "max_abs_err": err,
            "scales": scales}


# ------------------------------------------------------ resident train loop
RESIDENT_SETS = ["cache_device=true", "device_augment=true",
                 "transfer_uint8=true", "fused_accum=true"]


def resident(smi: str, stream: dict, bare_step_ms: float, augment_ms: float):
    """The flagship through the CLI with the dataset on the card: ``train``
    over the drivers' 128-image root (two epochs, an eval after the first)
    with every launch counter set to 0 just before, then ``eval`` of its
    best checkpoint over the cached eval set in both protocols."""
    import tempfile

    t_phase = time.perf_counter()
    records = Records()
    logging.getLogger("two_stage_object_detection_tpu_torch").addHandler(records)
    wrappers = counters()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = driver_data_root(os.path.join(tmp, "long"), LONG_IMAGES)
        weights = os.path.join(tmp, "weights")
        # the command line of README.md: one --set with the four pairs
        sets = [a for kv in DRIVER_SETS for a in ("--set", kv)]
        common = ["--flagship", "--data-root", root, "--weights", weights,
                  *sets, "--set", *RESIDENT_SETS]
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        run_cli(["train", *common, "--eval-period", "100", "--no-viz"])
        train_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in wrappers.items() if f.launches}
        epochs = [r for r in records.records if hasattr(r, "epoch")]
        caches = [r for r in records.records if hasattr(r, "cache_bytes")]
        require(len(epochs) == 2 and all(np.isfinite(r.loss) for r in epochs),
                f"the resident train logged {[(r.epoch, r.loss) for r in epochs]}")
        require(all(r.loop == "resident" for r in epochs),
                f"the train loop was {[r.loop for r in epochs]}, not resident")
        require(len(caches) == 2, f"{len(caches)} datasets placed on the card")
        require(launches.get("greedy_nms", 0) > 0
                and launches.get("windowed_align", 0) > 0,
                f"the resident train did not launch kernels 1 and 2: {launches}")
        e2 = epochs[1]
        step_ms = e2.seconds / e2.micro_steps * 1e3
        rate = e2.images / e2.seconds
        log(f"resident: datasets on the card: " + ", ".join(
            f"{r.cache_images} images, {r.cache_bytes / 1e6:.1f} MB"
            for r in caches))
        log(f"resident train (flagship, b=16, grad_accum_steps=2, "
            f"{LONG_IMAGES['train2017']} images, augmentation on the card): "
            f"{train_s:.1f} s in all; kernel launches {launches}")
        log(f"resident train loop, epoch 2: {rate:.1f} img/s ({e2.micro_steps} "
            f"micro-steps, {e2.images} images in {e2.seconds:.3f} s), "
            f"{step_ms:.1f} ms a micro-step; the streaming loop of the drivers "
            f"phase {stream['long_loop_img_per_s']:.1f} img/s "
            f"({stream['long_loop_step_ms']:.1f} ms); the bare micro-step "
            f"{bare_step_ms:.1f} ms + augment_batch {augment_ms:.2f} ms = "
            f"{16e3 / (bare_step_ms + augment_ms):.1f} img/s (epoch 1: "
            f"{epochs[0].images / epochs[0].seconds:.1f} img/s)")
        out.update(train_s=train_s, launches_train=launches,
                   cache_bytes=[r.cache_bytes for r in caches],
                   cache_images=[r.cache_images for r in caches],
                   epoch_s=[r.seconds for r in epochs],
                   epoch_loss=[r.loss for r in epochs], loop_img_per_s=rate,
                   loop_step_ms=step_ms, bare_step_ms=bare_step_ms,
                   augment_ms=augment_ms,
                   stream_loop_img_per_s=stream["long_loop_img_per_s"])
        out["eval"] = {}
        for flag, protocol in (([], "train-graph"), (["--predict"], "predict")):
            n = len(records.records)
            sweep = json.loads(run_cli(["eval", *common, "--checkpoint", "best",
                                        *flag]))
            seconds = [r.seconds for r in records.records[n:]
                       if getattr(r, "protocol", None) == protocol]
            placed = [r for r in records.records[n:]
                      if hasattr(r, "cache_bytes")]
            require(len(seconds) == 1 and len(placed) == 1,
                    f"eval {protocol}: not one timed pass over a cached set")
            vals = [sweep[k] for k in ("mAP50", "mAP95", "mAP50_95")]
            require(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals)
                    and np.isfinite(sweep["eval_loss"]),
                    f"eval {protocol}: {sweep}")
            log(f"resident eval --checkpoint best ({protocol}, "
                f"{placed[0].cache_images} images on the card): {sweep}; the "
                f"pass took {seconds[0]:.3f} s")
            out["eval"][protocol] = {**sweep, "seconds": seconds[0]}
        out["loop_probe"] = loop_probe(root)
    logging.getLogger("two_stage_object_detection_tpu_torch").removeHandler(
        records)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"resident phase: {out['phase_s']:.1f} s in all; card: {smi}")
    return out


def loop_probe(root: str):
    """Whether the resident loop waits for the card: one epoch of
    ``train.train_epoch``, the loop ``train()`` runs, over a quarter of the
    128 training images held on the card (two b=16 micro-steps, one
    accumulation cycle, augmented there), after one epoch to warm up,
    under PyTorch's sync debug mode and ``torch.profiler``.

    The debug mode sees the synchronising calls PyTorch makes (``.item()``,
    a blocking copy, ``torch.cuda.synchronize``), not a raw CUDA call in
    compiled code; the trace sees every CUDA runtime call, so each counts
    what the other may miss.  It fails unless both count 0 in the epoch and
    the trace holds fewer host-to-device copies than micro-steps (the
    epoch's one index copy: no batch comes from the host).  Returns the
    counts and the card's idle share over the epoch: the time from the
    epoch's start on the host to the end of its last device event that no
    kernel, copy or fill covers."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from two_stage_object_detection_tpu_torch.__main__ import _load_cfg
    from two_stage_object_detection_tpu_torch.data.coco import load_coco
    from two_stage_object_detection_tpu_torch.data.device_cache import (
        DeviceDatasetCache)
    from two_stage_object_detection_tpu_torch.data.pipeline import (
        DetectionDataset)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.train import (
        step_generator, train_epoch)
    from two_stage_object_detection_tpu_torch.utils.preemption import (
        PreemptionGuard)

    cfg = _load_cfg(argparse.Namespace(config=None, flagship=True,
                                       set=DRIVER_SETS + RESIDENT_SETS))
    idx = load_coco(os.path.join(root, "annotations",
                                 "instances_train2017.json"),
                    os.path.join(root, "train2017"), ratio=0.25, seed=None)
    ds = DetectionDataset(idx, cfg.input_size, cfg.max_gt_boxes,
                          decode_only=True, uint8_images=True)
    cache = DeviceDatasetCache(ds, cfg.batch_size, device=cfg.device)
    require(all(v.is_cuda for v in cache.data.values()),
            "the probe's cache is not on the card")
    _, state = create_train_state(cfg, seed=0, steps_per_epoch=len(cache))
    guard = PreemptionGuard()

    def epoch(e):
        return train_epoch(state, cache, 0, True,
                           lambda s: step_generator(0, e, s, cache.device),
                           guard)

    epoch(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("resident_epoch"):
                    pending, _ = epoch(1)
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = len(pending)
    require(steps == len(cache) == 2, f"the probe ran {steps} micro-steps")
    require(all(bool(torch.isfinite(t)) for t in pending),
            "the probe's losses are not finite")
    sites = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message)})
    n_debug = sum("synchroniz" in str(w.message) for w in caught)

    events = prof.events()
    win = [e for e in events if e.name == "resident_epoch"
           and e.device_type == DeviceType.CPU]
    require(len(win) == 1, f"{len(win)} traced epoch ranges")
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    host = [e for e in events if e.device_type == DeviceType.CPU
            and t0 <= e.time_range.start <= t1]
    syncs = sorted({e.name for e in host if "Synchronize" in e.name})
    n_sync = sum("Synchronize" in e.name for e in host)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.time_range.start >= t0
           and not getattr(e, "is_user_annotation", False)]
    htod = [e for e in dev if e.name.startswith("Memcpy HtoD")]
    dtoh = [e for e in dev if e.name.startswith("Memcpy DtoH")]
    require(dev, "the trace holds no device event in the epoch")
    end = max(t1, max(e.time_range.end for e in dev))
    busy, at = 0.0, t0
    for e in sorted(dev, key=lambda e: e.time_range.start):
        s, f = max(e.time_range.start, at), e.time_range.end
        if f > s:
            busy += f - s
            at = f
    idle = 1.0 - busy / (end - t0)
    log(f"resident epoch ({steps} micro-steps of train_epoch) under the sync "
        f"debug mode: {n_debug} synchronising calls at {sites}; traced: "
        f"{n_sync} synchronising runtime calls {syncs}, {len(htod)} "
        f"host-to-device and {len(dtoh)} device-to-host copies, "
        f"{len(dev)} device events; the card idle {idle:.1%} of "
        f"{(end - t0) / 1e3:.1f} ms (busy {busy / 1e3 / steps:.1f} ms a "
        f"micro-step)")
    require(n_debug == 0, f"the resident epoch synchronised at {sites}")
    require(n_sync == 0, f"the resident epoch called {syncs}")
    require(len(htod) < steps, f"{len(htod)} host-to-device copies in "
            f"{steps} micro-steps: batches came from the host")
    return {"debug_syncs": n_debug, "sites": sites, "runtime_syncs": n_sync,
            "htod_copies": len(htod), "dtoh_copies": len(dtoh),
            "device_events": len(dev), "window_ms": (end - t0) / 1e3,
            "busy_ms_per_step": busy / 1e3 / steps, "idle_share": idle}


# ------------------------------------------------------------ serving
SERVE_BUCKETS = (1, 2, 8, 16)
# three backbone convs of the flagship for the int8 accumulators: the stem
# (K = 3*7*7 = 147), a 3x3 over 64 channels and a 3x3 over 512
INT8_CONVS = ("extractor/conv1", "extractor/layer1_0/conv2",
              "extractor/layer4_1/conv2")


def jpeg_bodies():
    """The bytes of the three committed JPEGs of ``tests/data/real_coco``."""
    folder = os.path.join(FIXTURE, "train2017")
    out = []
    for name in sorted(os.listdir(folder)):
        if name.endswith(".jpg"):
            with open(os.path.join(folder, name), "rb") as f:
                out.append(f.read())
    return out


def host_ms(fn, n: int = 5) -> float:
    """Median host time of ``fn()`` over ``n`` calls after one to warm up;
    ``fn`` ends with its outputs on the host."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def serving(smi: str):
    """The serving phase on the flagship at full width (see the module
    docstring): the yuv420 wire, calibrated buckets, pipelined dispatch,
    the DynamicBatcher, the HTTP front, export and int8.  Counters are set
    to 0 just before each step; its launches stay out of the kernels
    line."""
    import http.client
    import tempfile
    import threading
    import warnings

    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    from two_stage_object_detection_tpu_torch.quantize import (
        calibrate, conv_int32, conv_int32_reference, eligible_convs,
        filter_scales, quantize_input, quantize_weight)
    from two_stage_object_detection_tpu_torch.serving import (
        DynamicBatcher, Predictor, _yuv420_unpack, export_program,
        load_exported, rgb_to_yuv420, yuv420_to_rgb_reference)
    from two_stage_object_detection_tpu_torch.serving_http import (
        DetectionServer, decode_image)

    t_phase = time.perf_counter()
    wrappers = counters()

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in wrappers.items() if fn.launches}

    cfg = Config(fpn=True, backbone="resnet50", loc_normalize=True)
    c32 = cfg.replace(compute_dtype="float32", score_thresh=0.0)
    h, w = cfg.input_size
    bodies = jpeg_bodies()
    u8 = np.stack([np.clip(np.rint(decode_image(b, (h, w))[0] * 255.0), 0,
                           255).astype(np.uint8) for b in bodies])
    req16 = u8[np.arange(16) % len(u8)]
    packed = rgb_to_yuv420(req16)
    rgb32 = yuv420_to_rgb_reference(packed, h, w)
    m16 = FasterRCNN(cfg, seed=0)
    m32 = FasterRCNN(c32, seed=1)
    out = {"card": smi}

    # a. the yuv420 wire
    dev_rgb = _yuv420_unpack(torch.from_numpy(packed).cuda(), h, w).cpu()
    require(np.array_equal(dev_rgb.numpy(), rgb32),
            "the yuv420 unpack on the card differs from its reference")
    zero()
    torch.backends.cudnn.deterministic = True   # for the f32 comparisons
    share, bitwise = agree(
        Predictor(c32, m32, SERVE_BUCKETS, wire="yuv420")(packed),
        Predictor(c32, m32, SERVE_BUCKETS)(rgb32))
    torch.backends.cudnn.deterministic = False
    log(f"serving yuv420: the unpack of 16 packed {h}x{w} planes on the card "
        f"equals yuv420_to_rgb_reference bit for bit; f32 (TF32 off) "
        f"Predictor(wire='yuv420') against Predictor(wire='f32') on the "
        f"reference pixels: {share:.3f} of slots agree (tolerance 0.95), "
        f"bitwise {bitwise}; launches {launched()}")
    require(share >= 0.95, "the yuv420 wire's detections differ")
    wires = {wire: Predictor(cfg, m16, SERVE_BUCKETS, wire=wire)
             for wire in ("f32", "u8", "yuv420")}
    reqs = {"f32": req16.astype(np.float32) / np.float32(255.0), "u8": req16,
            "yuv420": req16}
    out["wire_ms"] = {wire: host_ms(lambda: p(reqs[wire]))
                      for wire, p in wires.items()}
    out["yuv420_packed_ms"] = host_ms(lambda: wires["yuv420"](packed))
    log("serving wires, a 16-image request end to end (host clock, median of "
        "5; bf16; yuv420 packs the RGB request on the host): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in out["wire_ms"].items())
        + f"; yuv420 from packed planes {out['yuv420_packed_ms']:.2f} ms")

    # b. calibrated buckets
    t0 = time.perf_counter()
    calib = Predictor(cfg, m16, SERVE_BUCKETS, wire="yuv420", calibrate=True)
    out["calibrate_s"] = time.perf_counter() - t0
    out["bucket_ms"] = dict(calib._bucket_ms)
    out["plan"] = {n: list(calib._plan(n)) for n in range(1, 17)}
    log(f"serving calibrate=True ({out['calibrate_s']:.1f} s): bucket ms "
        + ", ".join(f"b={b} {v:.2f}" for b, v in out["bucket_ms"].items())
        + "; plan by request size " + " ".join(
            f"{n}:{'+'.join(map(str, p))}" for n, p in out["plan"].items()))

    # c. pipelined dispatch: 48 images as 16+16+16 in one request
    served = wires["yuv420"]
    req48 = np.concatenate([packed] * 3)
    require(served._plan(48) == (16, 16, 16), "48 images are not 3 buckets")
    out["one_48_ms"] = host_ms(lambda: served(req48))
    out["three_16_ms"] = host_ms(lambda: [served(packed) for _ in range(3)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            served(req48)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = sorted({f"{os.path.relpath(c.filename)}:{c.lineno}"
                    for c in caught if "synchroniz" in str(c.message)})
    out["syncs_48"] = sum("synchroniz" in str(c.message) for c in caught)
    out["sync_sites"] = sites
    log(f"serving pipelined dispatch (yuv420, bf16): one 48-image request "
        f"{out['one_48_ms']:.2f} ms against three 16-image requests "
        f"{out['three_16_ms']:.2f} ms (host clock, median of 5); under the "
        f"sync debug mode the 48-image request made {out['syncs_48']} "
        f"synchronising calls at {sites}, beside its 3 event waits (one a "
        "bucket's outputs)")

    # d. DynamicBatcher: 16 threads, 64 one-image requests, f32
    batched = Predictor(c32, m32, (1, 8, 16), wire="yuv420")
    singles = [req16[i % 16] for i in range(64)]
    results, lat = [None] * 64, [0.0] * 64
    torch.backends.cudnn.deterministic = True
    zero()
    with DynamicBatcher(batched, max_wait_ms=5.0) as dyn:
        def client(t):
            for i in range(t, 64, 16):
                t0 = time.perf_counter()
                results[i] = dyn.submit(singles[i]).result(timeout=300)
                lat[i] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    counts = launched()
    direct = [batched(s) for s in singles]
    got = {k: np.concatenate([r[k] for r in results]) for k in FIELDS}
    want = {k: np.concatenate([r[k] for r in direct]) for k in FIELDS}
    share, bitwise = agree(got, want)
    lat_sorted = sorted(lat)
    out["batcher"] = {"img_per_s": 64 / wall, "p50_ms": lat_sorted[31],
                      "p99_ms": lat_sorted[63], "flushes": dyn.flushes,
                      "agree": share, "bitwise": bitwise, "launches": counts}
    log(f"serving DynamicBatcher (f32, yuv420 wire, buckets (1, 8, 16), "
        f"max_wait 5 ms): 16 threads, 64 one-image requests in {wall:.2f} s "
        f"= {64 / wall:.1f} img/s; latency p50 {lat_sorted[31]:.1f} ms, p99 "
        f"{lat_sorted[63]:.1f} ms; {dyn.flushes} flushes; against a direct "
        f"call on each request {share:.3f} of slots agree (tolerance 0.95), "
        f"bitwise {bitwise}; launches {counts}")
    torch.backends.cudnn.deterministic = False
    require(share >= 0.95, "the DynamicBatcher's detections differ")
    for name in ("greedy_nms", "windowed_align"):
        require(counts.get(name, 0) > 0, f"the batcher never launched {name}")

    # e. the HTTP front
    sizes = [decode_image(b, (h, w))[1:] for b in bodies]
    zero()
    with DetectionServer(wires["yuv420"], max_wait_ms=5.0,
                         host="127.0.0.1", port=0).start() as srv:
        def post(body, path="/detect"):
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
            conn.request("POST", path, body=body,
                         headers={"Content-Length": str(len(body))})
            resp = conn.getresponse()
            payload = json.loads(resp.read().decode())
            conn.close()
            return resp.status, payload

        answers = []

        def http_client():
            for _ in range(8):
                for j, body in enumerate(bodies):
                    answers.append((j, *post(body)))
        t0 = time.perf_counter()
        threads = [threading.Thread(target=http_client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        bad_status, _ = post(b"this is not an image")
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("GET", "/nope")
        nope = conn.getresponse().status
        conn.close()
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = (resp.status, json.loads(resp.read().decode()))
        conn.close()
    counts = launched()
    require(len(answers) == 8 * 8 * len(bodies), "missing HTTP answers")
    n_det = 0
    for j, status, payload in answers:
        require(status == 200, f"HTTP {status}: {payload}")
        oh, ow = sizes[j]
        require(payload["image"] == {"height": oh, "width": ow},
                f"HTTP image size {payload['image']}")
        for d in payload["detections"]:
            x1, y1, x2, y2 = d["box"]
            require(0 <= x1 <= x2 <= ow + 0.01 and 0 <= y1 <= y2 <= oh + 0.01,
                    f"HTTP box {d['box']} outside a {ow}x{oh} image")
        n_det += len(payload["detections"])
    require(bad_status == 400, f"garbage bytes gave HTTP {bad_status}")
    require(nope == 404, f"/nope gave HTTP {nope}")
    require(health[0] == 200 and health[1]["status"] == "ok",
            f"/healthz gave {health}")
    out["http"] = {"requests_per_s": len(answers) / wall,
                   "requests": len(answers), "detections": n_det,
                   "launches": counts}
    log(f"serving HTTP (yuv420, bf16, 127.0.0.1): 8 client threads posted "
        f"the 3 JPEGs 8 times each, {len(answers)} requests in {wall:.2f} s "
        f"= {len(answers) / wall:.1f} requests/s, all 200 with boxes inside "
        f"each original image ({n_det} detections); garbage 400, /nope 404, "
        f"/healthz ok; launches {counts}")

    # f. export
    x16 = torch.from_numpy(rgb32).cuda()
    out["export"] = {}
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        single = FasterRCNN(Config(compute_dtype="float32", score_thresh=0.0),
                            seed=2)
        for label, model, expect in (
                ("flagship", m32, ("greedy_nms", "windowed_align")),
                ("single-scale", single,
                 ("fused_proposals_batched", "roi_pool_max"))):
            path = os.path.join(tmp, "program.pt2")
            t0 = time.perf_counter()
            nbytes = export_program(model.cfg, model, path, batch_size=16,
                                    portable=False)
            export_s = time.perf_counter() - t0
            run = load_exported(path)
            zero()
            got = outputs(run(x16))
            counts = launched()
            share, bitwise = agree(got, outputs(model.predict(x16)))
            loaded_ms = cuda_time_ms(lambda: run(x16), 5)
            eager_ms = cuda_time_ms(lambda: model.predict(x16), 5)
            out["export"][label] = {
                "export_s": export_s, "bytes": nbytes, "launches": counts,
                "agree": share, "bitwise": bitwise, "loaded_ms": loaded_ms,
                "eager_ms": eager_ms}
            log(f"serving export {label} (portable=False, f32, b=16): "
                f"{export_s:.1f} s, {nbytes} bytes; the loaded program "
                f"launched {counts}; against eager predict {share:.3f} of "
                f"slots agree (tolerance 0.95), bitwise {bitwise}; b=16 "
                f"{loaded_ms:.2f} ms loaded against {eager_ms:.2f} ms eager "
                "(CUDA events)")
            require(share >= 0.95, f"the exported {label} program differs")
            for name in expect:
                require(counts.get(name, 0) > 0,
                        f"the exported {label} program never launched {name}")
            os.unlink(path)
        del single
        path = os.path.join(tmp, "portable.pt2")
        t0 = time.perf_counter()
        nbytes = export_program(c32, m32, path, batch_size=1, portable=True)
        export_s = time.perf_counter() - t0
        run = load_exported(path)
        plain = FasterRCNN(c32.replace(pallas="off", pallas_roi=False))
        plain.load_state_dict(m32.state_dict())
        zero()
        got = outputs(run(x16[:1]))
        counts = launched()
        share, bitwise = agree(got, outputs(plain.predict(x16[:1])))
        out["export"]["portable"] = {"export_s": export_s, "bytes": nbytes,
                                     "launches": counts, "agree": share,
                                     "bitwise": bitwise}
        log(f"serving export flagship (portable=True, f32, b=1): "
            f"{export_s:.1f} s, {nbytes} bytes; launches on the card "
            f"{counts}; against eager pallas='off' {share:.3f} of slots "
            f"agree, bitwise {bitwise}")
        require(not counts, f"the portable program launched {counts}")
        require(share >= 0.95, "the portable program differs")
        del plain, run
    torch.backends.cudnn.deterministic = False

    # g. int8
    convs = eligible_convs(m16)
    inputs = {}
    hooks = [convs[name].register_forward_pre_hook(
        lambda _, args, name=name: inputs.setdefault(name, args[0]))
        for name in INT8_CONVS]
    x16b = torch.from_numpy(rgb32).cuda()
    m16.predict(x16b)
    for hk in hooks:
        hk.remove()
    out["int8_convs"] = {}
    for name in INT8_CONVS:
        conv, x = convs[name], inputs[name]
        x_q = quantize_input(x, float(x.abs().amax()) / 127.0)
        w_q, _ = quantize_weight(conv.weight)
        args = (x_q, w_q, conv.stride, conv.padding)
        acc = conv_int32(*args)
        ref = conv_int32_reference(*args)
        k = w_q[0].numel()
        require(torch.equal(acc, ref), f"int8 accumulators of {name} differ")
        out["int8_convs"][name] = {
            "x": list(x.shape), "w": list(w_q.shape), "K": k,
            "int_mm_ms": cuda_time_ms(lambda: conv_int32(*args), 5),
            "f64_ms": cuda_time_ms(lambda: conv_int32_reference(*args), 2)}
        log(f"serving int8 {name} x {list(x.shape)} w {list(w_q.shape)} "
            f"(K={k}): im2col + torch._int_mm accumulators equal the float64 "
            f"conv's bit for bit; "
            f"{out['int8_convs'][name]['int_mm_ms']:.2f} ms against "
            f"{out['int8_convs'][name]['f64_ms']:.2f} ms (CUDA events)")
    del inputs
    scales = filter_scales(calibrate(m16, [x16b[:4]]), prefix="extractor")
    quant = Predictor(cfg, m16, SERVE_BUCKETS, wire="u8", int8_scales=scales)
    zero()
    got = quant(req16)
    n_valid = check_outputs(got, 16, cfg)
    counts = launched()
    out["int8"] = {"convs": len(scales), "valid": n_valid,
                   "ms": host_ms(lambda: quant(req16)),
                   "bf16_ms": out["wire_ms"]["u8"], "launches": counts}
    log(f"serving int8: calibrate on 4 images, {len(scales)} extractor convs "
        f"in int8; a 16-image u8 request: {n_valid} valid detections, "
        f"finite; {out['int8']['ms']:.2f} ms against bf16 "
        f"{out['int8']['bf16_ms']:.2f} ms (host clock, median of 5); launches "
        f"{counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving phase: {out['phase_s']:.1f} s in all; card: {smi}")
    return out



# ------------------------------------------------------------ .pth import
def tv_name(key: str) -> str:
    """torchvision's name of a tensor of the port's ResNet trunk."""
    import re
    key = re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", key)
    return key.replace("ds_conv.", "downsample.0.").replace(
        "ds_norm.", "downsample.1.")


def tv_resnet50_dict(model, gen: torch.Generator) -> dict:
    """A torchvision-layout ``resnet50`` state dict (``conv1``, ``bn1``,
    ``layer{L}.{B}.{conv,bn}{i}``, ``downsample.{0,1}``, ``fc``,
    ``num_batches_tracked``; no PReLU slopes) of seeded random values, one
    entry for each tensor of ``model``'s trunk, renamed here from the
    port's names."""
    out = {}
    for k, v in model.extractor.state_dict().items():
        if k.endswith("relu.weight"):
            continue
        name = tv_name(k)
        if k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            val = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() == 4:
            val = torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5
        else:
            val = torch.randn(v.shape, generator=gen) * 0.1
        out[name] = val
        if k.endswith("running_var"):
            out[name.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(100))
    out["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    out["fc.bias"] = torch.zeros(1000)
    return out


def pth_import(smi: str) -> dict:
    """The ``.pth`` import phase (``utils/torch_import.py``); returns its
    numbers."""
    import tempfile

    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.utils.torch_import import (
        export_state_dict, load_resnet_backbone, load_torch_checkpoint)

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(12)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # HarDNet-39: the port's export -> a reference .pth -> a fresh model
        # (every score kept, so that random weights give detections)
        cfg = Config(score_thresh=0.0)
        src, _ = create_train_state(cfg, seed=0)
        t0 = time.perf_counter()
        sd = export_state_dict(src)
        path = os.path.join(tmp, "FasterRCNNTrainer_best.pth")
        torch.save({"model_state_dict": sd, "optimizer_state_dict": {}}, path)
        out["hardnet_export_s"] = time.perf_counter() - t0
        dst, state = create_train_state(cfg, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_torch_checkpoint(path, state)
        torch.cuda.synchronize()
        out["hardnet_import_s"] = time.perf_counter() - t0
        x = torch.from_numpy(train_batch(rng, cfg, 16, "f32")["image"]).cuda()
        a, b = src.predict(x), dst.predict(x)
        with torch.inference_mode():
            fa, fb = src.features(x), dst.features(x)
        require(torch.equal(fa, fb) and all(
            torch.equal(u, v) for u, v in zip(a, b)),
            "import: the HarDNet-39 .pth round trip predicts differently")
        require(int(a[3].sum()) > 0, "import: no detections")
        out.update(hardnet_keys=len(sd), hardnet_bytes=os.path.getsize(path),
                   hardnet_detections=int(a[3].sum()))
        del src, dst, state, a, b, fa, fb
        # ResNet-50, torchvision layout, into the flagship's trunk
        cfg = Config(fpn=True, backbone="resnet50", loc_normalize=True)
        direct, _ = create_train_state(cfg, seed=2)
        tv = tv_resnet50_dict(direct, torch.Generator().manual_seed(5))
        path = os.path.join(tmp, "resnet50.pth")
        torch.save(tv, path)
        with torch.no_grad():            # the same weights set directly
            for k, v in direct.extractor.state_dict().items():
                if k.endswith("relu.weight"):    # torchvision's plain ReLU
                    v.zero_()
                else:
                    v.copy_(tv[tv_name(k)])
        loaded, state = create_train_state(cfg, seed=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_resnet_backbone(path, state, blocks_num=(3, 4, 6, 3))
        torch.cuda.synchronize()
        out["resnet50_import_s"] = time.perf_counter() - t0
        img = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            taps_a, taps_b = direct.extractor(img), loaded.extractor(img)
        require(len(taps_a) == 4 and all(
            torch.equal(u, v) for u, v in zip(taps_a, taps_b)),
            "import: the ResNet-50 trunk differs from the same weights set "
            "directly")
        out.update(resnet50_keys=len(tv), resnet50_bytes=os.path.getsize(path),
                   resnet50_taps=[list(t.shape) for t in taps_a])
        del direct, loaded, state, taps_a, taps_b
    torch.backends.cudnn.deterministic = False
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"import: HarDNet-39 export_state_dict -> .pth ({out['hardnet_keys']} "
        f"keys, {out['hardnet_bytes']} bytes) -> load_torch_checkpoint into a "
        f"fresh model on the card: {out['hardnet_import_s']:.3f} s (export "
        f"and save {out['hardnet_export_s']:.3f} s); the stride-16 map and "
        f"b=16 predict (score_thresh 0) equal bit for bit "
        f"({out['hardnet_detections']} detections)")
    log(f"import: a torchvision-layout ResNet-50 dict ({out['resnet50_keys']} "
        f"keys, {out['resnet50_bytes']} bytes, no PReLU slopes) -> "
        f"load_resnet_backbone(blocks_num=(3, 4, 6, 3)) into the flagship: "
        f"{out['resnet50_import_s']:.3f} s; the trunk's taps "
        f"{out['resnet50_taps']} equal bit for bit the same weights set "
        f"directly")
    log(f"import phase: {out['phase_s']:.1f} s; card: {smi}")
    return out


# ------------------------------------------------------------ data parallel
DP_RANKS, DP_PER_RANK = 2, 8
TP_SHAPE = (2, 2)          # (data, model): 4 gloo ranks on the one card


def dp_config():
    """The flagship at full width in float32 (TF32 off: results are held
    against each other), ``grad_accum_steps=2``."""
    from two_stage_object_detection_tpu_torch.config import Config
    return Config(fpn=True, backbone="resnet50", loc_normalize=True,
                  compute_dtype="float32", grad_accum_steps=2,
                  batch_size=DP_PER_RANK)


def _grad_hook(model, into: dict):
    """Keeps the gradient each optimiser update consumes (after the
    all-reduce on a mesh; this rank's slice of a split parameter)."""
    def keep(*_):
        into.update({n: p.grad.detach().clone() for n, p
                     in model.named_parameters() if p.grad is not None})
    return keep


def _rpn_relu_hook(model, into: list):
    """Keeps, at every call of the RPN head's shared 3x3 conv (each pyramid
    level of each forward), its ReLU mask (the sign of its output) and
    where the backward brings that output a gradient: packed bits
    ``[B, C, H, ceil(W / 8)]`` uint8 on the host, ``{"mask", "grad"}``."""
    pack = lambda t: np.packbits(t.cpu().numpy(), axis=-1)

    def keep(_, __, out):
        item = {"mask": pack(out > 0)}
        into.append(item)
        if out.requires_grad:
            out.register_hook(lambda g: item.__setitem__("grad", pack(g != 0)))
    return model.rpn_head.conv.register_forward_hook(keep)


def _flips(got: list, want: list, rows: slice, steps: int = 2) -> list:
    """For each micro-step, the RPN head's ReLU units whose sign differs
    between two runs (:func:`_rpn_relu_hook`; ``want``'s images ``rows``),
    and how many of them carry a gradient in either run:
    ``[(flipped, with a gradient), ...]``."""
    per = len(want) // steps
    out = []
    for s in range(steps):
        f = g = 0
        for a, b in zip(got[s * per:(s + 1) * per],
                        want[s * per:(s + 1) * per]):
            x = a["mask"] ^ b["mask"][rows]
            ga = a.get("grad", np.zeros_like(a["mask"]))
            gb = b.get("grad", np.zeros_like(b["mask"]))[rows]
            f += int(np.unpackbits(x).sum())
            g += int(np.unpackbits(x & (ga | gb)).sum())
        out.append((f, g))
    return out


def _box_head_hook(model, into: list):
    """Keeps the box head's outputs of the first forward."""
    def keep(_, __, out):
        if not into:
            into.extend(t.detach().cpu() for t in out)
    return model.roi_head.register_forward_hook(keep)


def _moments_vs_float64(model, batch, group) -> dict:
    """One train-mode forward of ``batch`` (running statistics left alone)
    that holds, at every batch norm, the statistics over the ranks of
    ``group`` against float64: the layer's own combine
    (``models/layers.py:_global_moments``) and the float32 combine it
    replaced.  Returns the largest error of each over layers and channels,
    as each enters the normalised output: the mean's over
    ``sqrt(var + eps)``, the variance's over ``var + eps`` (float64 ``var``,
    the layer's ``eps`` 1e-5)."""
    from two_stage_object_detection_tpu_torch.models.layers import (
        BatchNorm, _global_moments, frozen_running_stats)
    from two_stage_object_detection_tpu_torch.nets.trainer import _images_f32
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_gather, all_reduce_)
    worst = {"new_mean": 0.0, "new_var": 0.0, "old_mean": 0.0,
             "old_var": 0.0, "layers": 0}
    dims = (0, 2, 3)

    def f32_combine(x):
        xf = x.detach().float()
        n = float(xf.numel() // xf.shape[1])
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        local = torch.stack([torch.full_like(mean, n), mean, var * n])
        count, means, m2s = all_gather(local, group).unbind(1)
        total = count.sum(0)
        g = (count * means).sum(0) / total
        return g, (m2s + count * (means - g) ** 2).sum(0) / total

    def check(_, args):
        x = args[0].detach()
        xd = x.double()
        sums = torch.stack([xd.sum(dims), torch.full_like(xd[0, :, 0, 0],
                                                          x.numel() / x.shape[1])])
        all_reduce_(sums, "sum", group)
        mean64 = sums[0] / sums[1]
        m2 = ((xd - mean64[:, None, None]) ** 2).sum(dims)
        all_reduce_(m2, "sum", group)
        scale = m2 / sums[1] + BatchNorm.EPS
        for tag, (mean, var) in (("new", _global_moments(x, group)[:2]),
                                 ("old", f32_combine(x))):
            worst[f"{tag}_mean"] = max(worst[f"{tag}_mean"], float(
                ((mean.double() - mean64).abs() / scale.sqrt()).max()))
            worst[f"{tag}_var"] = max(worst[f"{tag}_var"], float(
                ((var.double() + BatchNorm.EPS - scale).abs() / scale).max()))
        worst["layers"] += 1

    hooks = [m.register_forward_pre_hook(check) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad(), frozen_running_stats(model):
            b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            model.train_forward(_images_f32(b["image"]), b["boxes"],
                                b["labels"], b["valid"], train=True)
    finally:
        for h in hooks:
            h.remove()
    return worst


def _dp_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the data-parallel phase on ``cuda:0``: eval split
    over the ranks, the batch norms' statistics against float64, then two
    micro-steps and one update of the mesh train step on its 8 rows of each
    16-image batch, ``should_stop(sync=True)``, and the gradient
    all-reduce's time on its bytes.  Writes its numbers to ``tmp``; any
    failure raises, and the parent's join fails with it."""
    from two_stage_object_detection_tpu_torch.eval.evaluator import (
        collect_predictions)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        assert_replicated, make_mesh, place_train_state, state_tensors)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_reduce_, init_distributed)
    from two_stage_object_detection_tpu_torch.utils.preemption import (
        PreemptionGuard)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    init_distributed(f"file://{tmp}/gloo_store", world, rank,
                     backend="gloo", device="cuda:0")
    cfg = dp_config()
    # rank 0 holds the phase's weights, the others other seeds: the
    # placement's broadcast must make them equal
    model, state = create_train_state(cfg, seed=rank + 1, device="cuda:0")
    if rank == 0:
        model.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    mesh = make_mesh(devices=["cuda:0"])
    place_train_state(state, mesh, debug=True)
    data = torch.load(os.path.join(tmp, "batches.pt"), weights_only=False)
    rows = slice(rank * DP_PER_RANK, (rank + 1) * DP_PER_RANK)

    t0 = time.perf_counter()
    preds, _, eval_loss = collect_predictions(state, data["eval"], cfg)
    eval_s = time.perf_counter() - t0
    moments = _moments_vs_float64(
        model, {k: v[rows] for k, v in data["train"][0].items()}, mesh.group)

    grads, box, relu = {}, [], []
    state.optimizer.register_step_pre_hook(_grad_hook(model, grads))
    hooks = [_box_head_hook(model, box), _rpn_relu_hook(model, relu)]
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for g in data["train"]:
        mine = {k: v[rows] for k, v in g.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = train_step(state, mine)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    for h in hooks:
        h.remove()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    require(state.updates == 1, f"rank {rank}: {state.updates} updates")
    assert_replicated(state_tensors(state), mesh.group)

    n_params = sum(p.numel() for p in model.parameters())
    flat = torch.ones(n_params, device="cuda:0")
    all_reduce_(flat, "sum", mesh.group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        all_reduce_(flat, "sum", mesh.group)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 1e3 / 3

    guard = PreemptionGuard(sync_every=2)
    stopped_at = None
    for poll in range(1, 20):
        if rank == world - 1 and poll == 3:
            guard.request()
        if guard.should_stop(sync=True):
            stopped_at = poll
            break

    out = {"step_ms": step_ms, "losses": losses, "launches": launches,
           "peak_gb": peak / 1e9, "allreduce_ms": allreduce_ms,
           "allreduce_bytes": n_params * 4, "n_params": n_params,
           "stopped_at": stopped_at, "eval_s": eval_s,
           "eval_loss": eval_loss, "preds": preds, "moments": moments,
           "box": box, "relu": relu}
    if rank == 0:
        out["params"] = {k: v.cpu() for k, v in model.state_dict().items()}
        out["grads"] = {k: v.cpu() for k, v in grads.items()}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _timed_model_collectives(group) -> dict:
    """Counts, bytes and seconds of the collectives issued on ``group``
    (the model group's gathers and all-reduces), each timed alone between
    two synchronisations: the module attributes the tensor-parallel layers
    call are wrapped in place."""
    from two_stage_object_detection_tpu_torch.parallel import multiprocess
    stats = {"gather": [0, 0, 0.0], "reduce": [0, 0, 0.0]}
    inner = {"gather": multiprocess.all_gather,
             "reduce": multiprocess.all_reduce_}

    def timed(kind, call, t, g):
        if g is not group:
            return call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        s = stats[kind]
        s[0] += 1
        s[1] += t.numel() * t.element_size()
        s[2] += time.perf_counter() - t0
        return res

    multiprocess.all_gather = lambda t, group=None: timed(
        "gather", lambda: inner["gather"](t, group), t, group)
    multiprocess.all_reduce_ = lambda t, op="sum", group=None: timed(
        "reduce", lambda: inner["reduce"](t, op, group), t, group)
    return stats


def _tp_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of the tensor-parallel phase on ``cuda:0``: the
    ``(2, 2)`` mesh, ranks ``d * 2 + m``; data index ``d`` trains on the
    rows the data-parallel phase's rank ``d`` trained on, from the same
    weights; the dense heads split over each model group.  Two micro-steps
    and one update; the ranks of each data group must then hold the same
    state and those of each model group the same replicated tensors, bit for
    bit; the gathered checkpoint is saved.  Writes its numbers to
    ``tmp``."""
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        assert_replicated, make_mesh, place_train_state, state_tensors)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        init_distributed)
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_state_dict, split_parameters)
    from two_stage_object_detection_tpu_torch.utils import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    init_distributed(f"file://{tmp}/tp_store", world, rank,
                     backend="gloo", device="cuda:0")
    cfg = dp_config()
    model, state = create_train_state(cfg, seed=rank + 1, device="cuda:0")
    if rank == 0:
        model.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = make_mesh(*TP_SHAPE, devices=["cuda:0"])
    place_train_state(state, mesh, debug=True)
    place_s = time.perf_counter() - t0
    data = torch.load(os.path.join(tmp, "batches.pt"), weights_only=False)
    d = mesh.data_index
    rows = slice(d * DP_PER_RANK, (d + 1) * DP_PER_RANK)

    grads, box = {}, []
    state.optimizer.register_step_pre_hook(_grad_hook(model, grads))
    hook = _box_head_hook(model, box)
    comm = _timed_model_collectives(mesh.model_group)
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for g in data["train"]:
        mine = {k: v[rows] for k, v in g.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, mine)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    hook.remove()
    comm = {k: list(v) for k, v in comm.items()}
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    require(state.updates == 1, f"tp rank {rank}: {state.updates} updates")
    assert_replicated(state_tensors(state), mesh.group)
    assert_replicated(state_tensors(state, replicated_only=True),
                      mesh.model_group)
    full = gather_state_dict(model)
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(os.path.join(tmp, "tp_weights"), state,
                               checkpoint.LAST)
    save_s = time.perf_counter() - t0
    split = split_parameters(model)
    out = {"index": (d, mesh.model_index), "step_ms": step_ms, "comm": comm,
           "launches": launches, "peak_gb": peak / 1e9, "box": box,
           "place_s": place_s, "save_s": save_s,
           "split": {n: list(p.shape) for n, p in model.named_parameters()
                     if n in split},
           "grads": {k: v.cpu() for k, v in grads.items()
                     if k in split or rank == 0}}
    if rank == 0:
        out["params"] = {k: v.cpu() for k, v in full.items()}
    torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))


def _one_process_update(model, state, batches) -> dict:
    """Micro-steps over ``batches`` and one update in this process, timed;
    the gradient the update consumed, the parameters and statistics after
    it, on the host."""
    from two_stage_object_detection_tpu_torch.nets.trainer import train_step
    grads, relu = {}, []
    state.optimizer.register_step_pre_hook(_grad_hook(model, grads))
    hook = _rpn_relu_hook(model, relu)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, o = train_step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in o.items()})
    hook.remove()
    return {"ms": ms, "losses": losses, "relu": relu,
            "peak": torch.cuda.max_memory_allocated() / 1e9,
            "params": {k: v.cpu() for k, v in model.state_dict().items()},
            "grads": {k: v.cpu() for k, v in grads.items()}}


class convolutions_in_halves:
    """Inside, every 2-D convolution of a batch of ``2 * half`` images runs
    as two of ``half``, concatenated (autograd sums the halves' weight
    gradients): one process's convolutions at the ranks' batch size, its
    batch norms still over the whole batch."""

    def __init__(self, half: int):
        self.half = half

    def __enter__(self):
        import torch.nn.functional as F
        self.inner = F.conv2d

        def conv2d(x, *a, **k):
            if x.shape[0] != 2 * self.half:
                return self.inner(x, *a, **k)
            return torch.cat([self.inner(x[:self.half], *a, **k),
                              self.inner(x[self.half:], *a, **k)])
        F.conv2d = conv2d
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.conv2d = self.inner


def _rel_by_module(got: dict, want: dict, names) -> dict:
    """The relative error, in norm, of ``got`` against ``want`` over each
    top-level module's parameters, and over all (``"all"``)."""
    sums = {}
    for n in names:
        d = float((got[n].double() - want[n].double()).norm() ** 2)
        r = float(want[n].double().norm() ** 2)
        for part in (n.split(".")[0], "all"):
            a, b = sums.get(part, (0.0, 0.0))
            sums[part] = (a + d, b + r)
    return {k: (a / b) ** 0.5 for k, (a, b) in sums.items()}


def _flat(tensors: dict, names) -> torch.Tensor:
    return torch.cat([tensors[n].reshape(-1).double() for n in names])


def data_parallel(smi: str):
    """The data-parallel and tensor-parallel phases (see the module
    docstring); returns their numbers."""
    import tempfile

    import torch.multiprocessing as mp

    from two_stage_object_detection_tpu_torch.eval.evaluator import (
        collect_predictions)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, place_train_state)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        init_distributed)
    from two_stage_object_detection_tpu_torch.serving import Predictor
    import torch.distributed as dist

    t_phase = time.perf_counter()
    out = {}
    cfg = dp_config()
    rng = np.random.RandomState(10)
    torch.backends.cudnn.deterministic = True

    # Predictor over a mesh of the card's one device: one replica, bitwise
    model, _ = create_train_state(cfg.replace(compute_dtype="bfloat16"),
                                  seed=0)
    req = np.stack([train_batch(rng, cfg, 1)["image"][0] for _ in range(16)])
    plain = Predictor(model.cfg, model, batch_sizes=(16,), wire="u8")(req)
    meshed = Predictor(model.cfg, model, batch_sizes=(16,), wire="u8",
                       mesh=make_mesh(devices=["cuda:0"]))(req)
    for k in FIELDS:
        require(np.array_equal(plain[k], meshed[k]),
                f"Predictor(mesh=) over one device: {k} differs")
    require(int(plain["valid"].sum()) > 0, "Predictor(mesh=): no detections")
    log(f"data parallel: Predictor(mesh=) over cuda:0 equals the meshless "
        f"Predictor bit for bit on a 16-image request "
        f"({int(plain['valid'].sum())} detections)")
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # NCCL, a world of 1: the mesh step against the meshless one
        init_distributed(f"file://{tmp}/nccl_store", 1, 0, backend="nccl",
                         device="cuda:0")
        try:
            c4 = cfg.replace(batch_size=4)
            nccl_batches = [train_batch(rng, c4, 4) for _ in range(2)]
            states = []
            for meshed in (False, True):
                model, state = create_train_state(c4, seed=0)
                if meshed:
                    place_train_state(state, make_mesh())
                for b in nccl_batches:
                    train_step(state, b)
                states.append({k: v.clone() for k, v
                               in model.state_dict().items()})
                del model, state
            same = all(torch.equal(states[0][k], states[1][k])
                       for k in states[0])
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        require(backend == "nccl" and same, "NCCL world 1: the mesh train "
                "step differs from the meshless one")
        log("data parallel: NCCL, a world of 1: two micro-steps and one "
            "update of the mesh train step (b=4, f32) equal the meshless "
            "step's bit for bit (parameters and running statistics)")
        del states
        torch.cuda.empty_cache()

        # the one-process reference: b=16, the same two batches, one update
        model, state = create_train_state(cfg.replace(batch_size=16), seed=0)
        torch.save(model.state_dict(), os.path.join(tmp, "weights.pt"))
        train_b = [train_batch(rng, cfg, DP_RANKS * DP_PER_RANK)
                   for _ in range(2)]
        eval_b = [train_batch(rng, cfg, DP_RANKS * DP_PER_RANK)
                  for _ in range(2)]
        torch.save({"train": train_b, "eval": eval_b},
                   os.path.join(tmp, "batches.pt"))
        blocks = [{k: v[i:i + DP_PER_RANK] for k, v in b.items()}
                  for b in eval_b for i in range(0, 16, DP_PER_RANK)]
        ref_preds, _, ref_eval_loss = collect_predictions(state, blocks, cfg)
        ref = _one_process_update(model, state, train_b)
        del model, state
        torch.cuda.empty_cache()
        # the controls, each one process against the reference:
        # * rounding: the same update on each batch's images in reverse
        #   order, the same mathematical gradient, rounded another way;
        # * convolutions in halves: the same update with every convolution
        #   at the ranks' batch of 8 (cuDNN picks its algorithm by shape)
        #   and the batch norms over all 16, as the ranks' are;
        # * half batch: the ranks' halves of each batch as micro-steps of
        #   their own (b=8, grad_accum_steps=4), the halves' gradients
        #   averaged: the ranks' convolution batch size, and a batch norm
        #   over 8 images where the ranks' takes all 16
        model, state = create_train_state(cfg.replace(batch_size=16), seed=0)
        ctl = _one_process_update(model, state, [
            {k: v[::-1].copy() for k, v in b.items()} for b in train_b])
        del model, state
        torch.cuda.empty_cache()
        model, state = create_train_state(cfg.replace(batch_size=16), seed=0)
        with convolutions_in_halves(DP_PER_RANK):
            conv8 = _one_process_update(model, state, train_b)
        del model, state
        torch.cuda.empty_cache()
        model, state = create_train_state(cfg.replace(grad_accum_steps=4),
                                          seed=0)
        half = _one_process_update(model, state, [
            {k: v[i:i + DP_PER_RANK] for k, v in b.items()}
            for b in train_b for i in range(0, 16, DP_PER_RANK)])
        del model, state
        torch.cuda.empty_cache()
        ref_ms, ref_losses, ref_peak = ref["ms"], ref["losses"], ref["peak"]
        ref_params, ref_grads = ref["params"], ref["grads"]

        t0 = time.perf_counter()
        mp.start_processes(_dp_rank, args=(DP_RANKS, tmp), nprocs=DP_RANKS,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_RANKS)]

        n_tp = TP_SHAPE[0] * TP_SHAPE[1]
        t0 = time.perf_counter()
        mp.start_processes(_tp_rank, args=(n_tp, tmp), nprocs=n_tp,
                           start_method="spawn")
        tp_s = time.perf_counter() - t0
        tps = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"),
                          weights_only=False) for r in range(n_tp)]
        tp_ckpt = tp_checkpoint_check(tmp, tps[0]["params"], train_b[0])

    for r, got in enumerate(ranks):
        for name in ("greedy_nms", "windowed_align"):
            require(got["launches"][name] > 0,
                    f"data parallel: rank {r} never launched {name}")
        require(got["stopped_at"] == 4, f"data parallel: rank {r} stopped at "
                f"poll {got['stopped_at']}, not 4")
        require(len(got["preds"]) == len(ref_preds), "eval length differs")
        for a, b in zip(got["preds"], ref_preds):
            require(all(np.array_equal(x, y) for x, y in zip(a, b)),
                    f"data parallel: rank {r}'s eval predictions differ from "
                    "the one-process pass over the same blocks")
        require(abs(got["eval_loss"] - ref_eval_loss)
                <= 1e-6 * max(1.0, abs(ref_eval_loss)),
                f"data parallel: rank {r}'s eval loss differs")
    require(ranks[0]["eval_loss"] == ranks[1]["eval_loss"],
            "the ranks' eval losses differ")
    names = sorted(ref_grads)
    require(sorted(ranks[0]["grads"]) == names,
            "data parallel: another set of parameters has gradients")
    p_dp = _flat(ranks[0]["params"], names)
    p_1 = _flat(ref_params, names)
    close = float(((p_dp - p_1).abs() <= 1e-5 + 1e-5 * p_1.abs())
                  .double().mean())
    loss_rel = max(abs(np.mean([rk["losses"][i]["total"] for rk in ranks])
                       - ref_losses[i]["total"]) / abs(ref_losses[i]["total"])
                   for i in range(2))
    stats = [k for k in ref_params if k.endswith(("running_mean",
                                                  "running_var"))]
    stat_err = max(float((ranks[0]["params"][k] - ref_params[k]).abs().max())
                   for k in stats)
    dp_err = _rel_by_module(ranks[0]["grads"], ref_grads, names)
    ctl_err = _rel_by_module(ctl["grads"], ref_grads, names)
    conv8_err = _rel_by_module(conv8["grads"], ref_grads, names)
    half_err = _rel_by_module(half["grads"], ref_grads, names)
    dp_half = _rel_by_module(ranks[0]["grads"], half["grads"], names)
    dp_conv8 = _rel_by_module(ranks[0]["grads"], conv8["grads"], names)
    moments = {k: max(rk["moments"][k] for rk in ranks)
               for k in ranks[0]["moments"]}
    per = DP_PER_RANK
    by_rank = [_flips(rk["relu"], ref["relu"], slice(r * per, (r + 1) * per))
               for r, rk in enumerate(ranks)]
    flips = {"ranks": [tuple(map(sum, zip(*s))) for s in zip(*by_rank)],
             "conv_halves": _flips(conv8["relu"], ref["relu"], slice(None)),
             "units_a_step": int(sum(np.unpackbits(m["mask"]).size
                                     for m in ref["relu"]) // 2)}
    grad_rel = dp_err["all"]
    log("data parallel: the gradient's relative error by module against one "
        "process at b=16 -- the ranks; the rounding control (one process on "
        "the images in reverse order); the half-batch control (one process "
        "on each rank's 8 images as micro-steps of their own, batch norm "
        "over 8); the convolutions-in-halves control (one process, every "
        "convolution at b=8, batch norm over 16): " + ", ".join(
            f"{k} {dp_err[k]:.2e}; {ctl_err[k]:.2e}; {half_err[k]:.2e}; "
            f"{conv8_err[k]:.2e}" for k in dp_err))
    log(f"data parallel: the RPN head's ReLU units (the sign of its shared "
        f"3x3 conv's output over P2..P6, {flips['units_a_step']} a "
        f"micro-step) that differ from one process at b=16, and of those "
        f"the units with a gradient, at micro-steps 1 and 2: the ranks "
        f"{flips['ranks']}, the convolutions-in-halves control "
        f"{flips['conv_halves']}")
    log("data parallel: the ranks against the half-batch control: "
        + ", ".join(f"{k} {v:.2e}" for k, v in dp_half.items())
        + "; against the convolutions-in-halves control: "
        + ", ".join(f"{k} {v:.2e}" for k, v in dp_conv8.items()))
    log(f"data parallel: the cross-replica batch norm's statistics against "
        f"float64 over {moments['layers']} layers, on the batch-norm inputs "
        f"of the first micro-step, as they enter the normalised output: the "
        f"layer's combine (float64) mean {moments['new_mean']:.2e} of "
        f"sqrt(var + eps), variance {moments['new_var']:.2e} of var + eps; "
        f"the float32 combine it replaced {moments['old_mean']:.2e}, "
        f"{moments['old_var']:.2e}")
    # the ranks compute one process's b=16 gradient up to rounding; the
    # control that differs from them in rounding alone runs every
    # convolution at their batch of 8 (cuDNN picks its algorithm by shape)
    # with the batch norms over 16, and the gate is twice its reading.  On
    # an H100 80GB HBM3 at 700 W: the ranks 4.45e-3, this control 4.30e-3,
    # the reverse-order control 3.48e-3, the half-batch control 2.15e-1
    gate = 2.0 * conv8_err["all"]
    log(f"data parallel: {DP_RANKS} gloo ranks on cuda:0, {DP_PER_RANK} "
        f"images a rank, grad_accum_steps=2, flagship 600x600 f32 (TF32 "
        f"off); the ranks' states equal bit for bit after one update; "
        f"against one process at b=16: the all-reduced gradient's relative "
        f"error {grad_rel:.2e} (gate {gate:.2e}: twice the "
        f"convolutions-in-halves control's {conv8_err['all']:.2e}), "
        f"{close:.6f} of parameter "
        f"elements within 1e-5 + 1e-5 |p| (tolerance 0.99), the total loss "
        f"(mean of the ranks') within {loss_rel:.2e} relative (tolerance "
        f"1e-3), running statistics within {stat_err:.2e} (tolerance 1e-5)")
    require(grad_rel <= gate, "data parallel: the gradient differs from one "
            "process's by more than twice the convolutions-in-halves "
            "control's")
    require(close >= 0.99, "data parallel: the update differs")
    require(loss_rel <= 1e-3, "data parallel: the losses differ")
    require(stat_err <= 1e-5, "data parallel: the statistics differ")
    require(moments["new_mean"] <= 1e-5 and moments["new_var"] <= 1e-5,
            "data parallel: the cross-replica statistics differ from float64")
    for r, got in enumerate(ranks):
        log(f"data parallel rank {r}: micro-step ms "
            f"{[round(t, 1) for t in got['step_ms']]} (one process at b=16: "
            f"{[round(t, 1) for t in ref_ms]}); gradient all-reduce "
            f"{got['allreduce_ms']:.1f} ms for {got['allreduce_bytes']} "
            f"bytes ({got['n_params']} float32 parameters, gloo through "
            f"pinned host memory); peak memory {got['peak_gb']:.2f} GB (one "
            f"process at b=16: {ref_peak:.2f} GB); kernel launches "
            f"{got['launches']}; should_stop(sync=True) stopped at poll "
            f"{got['stopped_at']}; eval split over the ranks "
            f"{got['eval_s']:.2f} s, equal to one process bit for bit")
    out.update({"grad_rel_err": grad_rel, "grad_gate": gate,
                "param_close_share": close,
                "grad_rel_by_module": dp_err, "control_rel_by_module": ctl_err,
                "half_batch_rel_by_module": half_err,
                "conv_halves_rel_by_module": conv8_err,
                "ranks_vs_half_batch_by_module": dp_half,
                "ranks_vs_conv_halves_by_module": dp_conv8,
                "moments_vs_float64": moments, "rpn_relu_flips": flips,
                "loss_rel_err": loss_rel, "stat_err": stat_err,
                "ranks_s": ranks_s, "one_process_step_ms": ref_ms,
                "one_process_peak_gb": ref_peak,
                "ranks": [{k: v for k, v in got.items()
                           if k not in ("params", "grads", "preds", "box",
                                        "relu")}
                          for got in ranks]})
    out["tensor_parallel"] = tensor_parallel(smi, tps, ranks, names, tp_s,
                                             tp_ckpt)
    torch.backends.cudnn.deterministic = False
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"data and tensor parallel phases: {out['phase_s']:.1f} s in all "
        f"(the data-parallel ranks {ranks_s:.1f} s, the tensor-parallel ranks "
        f"{tp_s:.1f} s); card: {smi}")
    return out


def tp_checkpoint_check(tmp: str, params: dict, batch: dict) -> dict:
    """The tensor-parallel ranks' gathered checkpoint restored into one
    process on the card, its predict against that of a model holding the
    gathered parameters: bit for bit."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.utils import checkpoint
    cfg = dp_config().replace(score_thresh=0.0)    # every score kept
    model, state = create_train_state(cfg, seed=9)
    t0 = time.perf_counter()
    require(checkpoint.restore_checkpoint(os.path.join(tmp, "tp_weights"),
                                          state, checkpoint.LAST) is not None,
            "tensor parallel: no checkpoint")
    restore_s = time.perf_counter() - t0
    require((state.step, state.updates) == (2, 1),
            f"tensor parallel: the checkpoint holds step {state.step}")
    direct = FasterRCNN(cfg)
    direct.load_state_dict(params)
    x = torch.from_numpy(batch["image"][:8]).cuda().float() / 255.0
    a, b = model.predict(x), direct.predict(x)
    with torch.inference_mode():
        fa, fb = model.features(x), direct.features(x)
    same = all(torch.equal(u, v) for u, v in zip((*a, *fa), (*b, *fb)))
    require(same, "tensor parallel: the gathered checkpoint predicts "
            "differently from the gathered parameters")
    return {"restore_s": restore_s, "detections": int(a[3].sum())}


def tensor_parallel(smi: str, tps: list, dps: list, names, tp_s: float,
                    ckpt: dict) -> dict:
    """The checks and numbers of the tensor-parallel ranks against the
    data-parallel ranks of the same batches."""
    split = sorted(tps[0]["split"])
    n_model = TP_SHAPE[1]
    require(split == sorted(["roi_head.fc1.weight", "roi_head.fc2.weight",
                             "roi_head.cls_loc.weight"]),
            f"tensor parallel: split {split}")
    for r, got in enumerate(tps):
        require(got["index"] == divmod(r, n_model), "tensor parallel: layout")
        for name in ("greedy_nms", "windowed_align"):
            require(got["launches"][name] > 0,
                    f"tensor parallel: rank {r} never launched {name}")
    grads = {n: (torch.cat([tps[m]["grads"][n] for m in range(n_model)])
                 if n in split else tps[0]["grads"][n]) for n in names}
    tp_err = _rel_by_module(grads, dps[0]["grads"], names)
    shapes = ", ".join(f"{n} {tps[0]['split'][n]}" for n in split)
    box_rel = 0.0
    for d in range(TP_SHAPE[0]):
        for a, b in zip(tps[d * n_model]["box"], dps[d]["box"]):
            box_rel = max(box_rel, float((a.double() - b.double()).norm()
                                         / b.double().norm()))
    log(f"tensor parallel: a {TP_SHAPE} mesh of {len(tps)} gloo ranks on "
        f"cuda:0 (ranks d * {n_model} + m), flagship 600x600 f32 (TF32 off), "
        f"{DP_PER_RANK} images a data index, grad_accum_steps=2, split: "
        f"{shapes} a rank "
        f"(roi_head.score [81, 1024] stays whole); against the data-parallel "
        f"ranks on the same batches: the box head's outputs within "
        f"{box_rel:.2e} relative (tolerance 1e-5), the all-reduced gradient "
        f"gathered into the full layout within {tp_err['all']:.2e} relative "
        f"in norm (tolerance 1e-4; by module " + ", ".join(
            f"{k} {v:.2e}" for k, v in tp_err.items() if k != "all")
        + "); each data group's states and each model group's replicated "
        "tensors equal bit for bit after the update; the gathered checkpoint "
        f"restored into one process in {ckpt['restore_s']:.2f} s predicts "
        f"bit for bit like the gathered parameters ({ckpt['detections']} "
        f"detections on 8 images)")
    require(box_rel <= 1e-5, "tensor parallel: the box head's outputs differ")
    require(tp_err["all"] <= 1e-4, "tensor parallel: the gradient differs")
    dp_ms = [[round(t, 1) for t in dp["step_ms"]] for dp in dps]
    for r, got in enumerate(tps):
        steps = len(got["step_ms"])
        g, a = got["comm"]["gather"], got["comm"]["reduce"]
        log(f"tensor parallel rank {r} {got['index']}: micro-step ms "
            f"{[round(t, 1) for t in got['step_ms']]} (data parallel rank "
            f"{got['index'][0]}: {dp_ms[got['index'][0]]}); "
            f"a micro-step's model-group collectives: {g[0] / steps:.0f} "
            f"gathers, {g[1] / steps / 1e6:.2f} MB sent, "
            f"{g[2] / steps * 1e3:.1f} ms; {a[0] / steps:.0f} all-reduces, "
            f"{a[1] / steps / 1e6:.2f} MB, {a[2] / steps * 1e3:.1f} ms (gloo "
            f"through pinned host memory, each timed alone); peak memory "
            f"{got['peak_gb']:.2f} GB (data parallel: "
            f"{dps[got['index'][0]]['peak_gb']:.2f} GB); placement "
            f"{got['place_s']:.2f} s, checkpoint save {got['save_s']:.2f} s; "
            f"kernel launches {got['launches']}")
    log(f"tensor parallel: card {smi}")
    return {"grad_rel_vs_dp": tp_err, "box_rel_vs_dp": box_rel,
            "ranks_s": tp_s, "checkpoint": ckpt,
            "ranks": [{k: v for k, v in got.items()
                       if k not in ("params", "grads", "box")}
                      for got in tps]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measured numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; card: {smi}")
    t0 = time.perf_counter()
    reports = _cuda.build_all()
    log(f"built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    nms_row, nms_shapes = check_nms(rng, dev)
    align_row, align_shapes = check_align(rng, dev)
    fused_rows, fused_shapes = check_fused(rng, dev)
    kernels = [nms_row, align_row, *fused_rows]
    pool_row, pool_shapes = check_roi_pool(rng, dev)
    bwd_rows, bwd_shapes = check_roi_pool_bwd(rng, dev)
    kernels += [pool_row, *bwd_rows]
    cap_shapes = check_above_cap(rng, dev)
    torch.cuda.empty_cache()

    paths = {"flagship": (Config(fpn=True, backbone="resnet50",
                                 loc_normalize=True),
                          ("greedy_nms", "windowed_align")),
             "single-scale": (Config(), ("fused_proposals_batched",
                                         "roi_pool_max"))}
    launches, detections, perf, parity = {}, {}, {}, {}
    for label, (cfg, expect) in paths.items():
        counts, detections[label], perf[label] = serve(cfg, rng, label, expect)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
        parity[label] = f32_parity(cfg, rng, label)
        torch.cuda.empty_cache()

    # three train paths at full width: the scatter kernel is the backward
    # of the single scale's other kernel route, pallas_roi=True
    train_paths = {
        "flagship": (paths["flagship"][0], ("greedy_nms", "windowed_align")),
        "single-scale": (Config(roi_bwd="pallas"), (
            "fused_proposals_batched", "roi_pool_max",
            "roi_pool_bwd_recompute")),
        "single-scale pallas_roi": (Config(pallas_roi=True), (
            "fused_proposals_batched", "roi_pool_max",
            "roi_pool_bwd_scatter"))}
    train_perf, train_par = {}, {}
    for label, (cfg, expect) in train_paths.items():
        counts, train_perf[label] = train(cfg, rng, label, expect)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
        train_par[label] = train_parity(cfg, rng, label)
        torch.cuda.empty_cache()
    mode_launches, mode_ms = train_modes(Config(), rng)
    torch.cuda.empty_cache()
    driver = drivers(paths["flagship"][0], smi,
                     train_perf["flagship"]["warm_step_ms"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    routes = {}
    route_paths = {
        "flagship dense": (paths["flagship"][0].replace(fpn_roi_window=0),
                           ("greedy_nms",), ("windowed_align",), "flagship"),
        "single-scale align": (Config(roi_pool_mode="align"),
                               ("fused_proposals_batched",),
                               ("roi_pool_max",), "single-scale"),
        "single-scale mean": (Config(roi_pool_mode="mean"),
                              ("fused_proposals_batched",),
                              ("roi_pool_max",), "single-scale")}
    for label, (cfg, expect, absent, kernel_route) in route_paths.items():
        routes[label] = roi_route(cfg, rng, label, expect, absent,
                                  perf[kernel_route]["stages_ms"]["roi_head"])
    routes_s = time.perf_counter() - t0
    log(f"RoI routes phase: {routes_s:.1f} s")
    augment = device_augment(rng)
    torch.cuda.empty_cache()
    resident_run = resident(smi, driver, train_perf["flagship"]["warm_step_ms"],
                            augment["ms"])
    torch.cuda.empty_cache()
    serving_run = serving(smi)
    torch.cuda.empty_cache()
    import_run = pth_import(smi)
    torch.cuda.empty_cache()
    dp_run = data_parallel(smi)
    torch.cuda.empty_cache()

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{**{key: k[key] for key in keys},
                         **{key: k[key] for key in ("sources",) if key in k}}
                        for k in kernels]}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__,
                       "cuda": torch.version.cuda, **line, "predict": perf,
                       "detections": detections, "f32_parity": parity,
                       "train": train_perf, "train_f32_parity": train_par,
                       "train_modes_ms": mode_ms,
                       "train_modes_launches": mode_launches,
                       "drivers": driver, "roi_routes": routes,
                       "roi_routes_s": routes_s, "device_augment": augment,
                       "resident": resident_run, "serving": serving_run,
                       "pth_import": import_run, "data_parallel": dp_run,
                       "fused_proposals_shapes": fused_shapes,
                       "roi_pool_max_shapes": pool_shapes,
                       "roi_pool_bwd_shapes": bwd_shapes,
                       "above_row_cap_shapes": cap_shapes,
                       "greedy_nms_shapes": nms_shapes,
                       "windowed_align_shapes": align_shapes}, f,
                      indent=1)
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
