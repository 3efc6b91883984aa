"""Serving: batch buckets, request wires, measured costs, dynamic batching
and export.

The counterpart of the JAX package's ``serving.py``, name for name:

* :class:`Predictor`: a request of ``n`` images is cut into a sequence of
  fixed batch buckets (:meth:`Predictor._plan`: the size heuristic, or the
  buckets' measured costs with ``calibrate=True``), each chunk padded up to
  its bucket, and the results truncated back.  At most two buckets are in
  flight: each chunk is staged in pinned host memory and copied on a side
  stream while the previous bucket computes, and its outputs come back
  with an asynchronous copy that is waited for only when the third bucket
  is due.  Three request wires: ``"f32"`` ([0, 1] floats), ``"u8"``
  ([0, 255] bytes, converted on the device) and ``"yuv420"`` (4:2:0
  planes, :func:`rgb_to_yuv420`, unpacked on the device by
  :func:`_yuv420_unpack`).  ``int8_scales`` serves the dense convs in int8
  (``quantize.py``).
* :class:`DynamicBatcher`: requests from many threads collated into shared
  bucket runs.
* :func:`export_program` / :func:`load_exported`: ``torch.export`` of the
  predict path with the weights in it, in place of the JAX package's
  StableHLO export.  ``portable=True`` exports the plain PyTorch path,
  which runs on the CPU or the card; ``portable=False`` keeps the CUDA
  kernels as the port's custom ops (``tsod::*``), a CUDA-only artifact.

A Mask R-CNN (``Config(mask_head=True)``) answers a fifth field, ``masks``:
each detection's 28x28 mask probabilities on its own box, float16;
:func:`paste_masks` pastes them into the image, on the device, for a caller
that wants bitmaps.

:meth:`Predictor.from_checkpoint` loads the port's own checkpoints
(``utils/checkpoint.py``); :meth:`Predictor.from_jax_variables` takes the
JAX package's flax variables as numpy trees.  ``mesh`` (a
:class:`~.parallel.mesh.Mesh` over devices of this process) serves from one
replica of the weights a data index, each bucket the data axis divides
split along the batch over them (a model axis adds no replica: the
parameters stay whole, as in the JAX package's ``Predictor``); with
``spatial`` a bucket's images are also split by rows over the model axis,
one worker thread a device, whose backbones and necks exchange halos
(``parallel/spatial.py``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import os
import threading
import time
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.registry import check_route
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.ops.geometry import div_exact
from two_stage_object_detection_tpu_torch.utils.profiling import annotate

FIELDS = ("boxes", "scores", "labels", "valid")
# the fields of a Mask R-CNN's answers: a fifth, its masks
FIELDS_WITH_MASKS = (*FIELDS, "masks")

# BT.601 full-range RGB -> YCbCr, the matrix every JPEG codec uses
# (ITU-T T.871), float32 as in the JAX package
_YUV_FWD = np.array([[0.299, 0.587, 0.114],
                     [-0.168736, -0.331264, 0.5],
                     [0.5, -0.418688, -0.081312]], np.float32)


def rgb_to_yuv420(images: np.ndarray) -> np.ndarray:
    """Pack RGB uint8 ``[N, H, W, 3]`` (or one ``[H, W, 3]``) into the
    yuv420 wire layout, one uint8 plane ``[N, H + H//2, W]``: rows ``0:H``
    are the luma Y, rows ``H:`` the 2x2 box-averaged chroma, ``Cb`` in
    columns ``0:W//2`` and ``Cr`` in ``W//2:``, biased by 128.  1.5 bytes a
    pixel against the u8 wire's 3.  Needs even ``H`` and ``W``.  The native
    library packs when it is built (``data/native.py``), numpy otherwise,
    each byte for byte as the JAX package's same path; the two paths differ
    by at most one code value where a sum rounds the other way."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    if images.dtype != np.uint8 or images.shape[-1] != 3:
        raise ValueError(f"rgb_to_yuv420 takes uint8 RGB, got "
                         f"{images.dtype} {images.shape}")
    n, h, w, _ = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even H, W; got {(h, w)}")
    from two_stage_object_detection_tpu_torch.data import native
    packed = native.rgb_to_yuv420(images)
    if packed is not None:
        return packed
    yuv = images.astype(np.float32) @ _YUV_FWD.T        # U/V centred at 0
    out = np.empty((n, h + h // 2, w), np.uint8)
    out[:, :h, :] = np.clip(np.rint(yuv[..., 0]), 0, 255).astype(np.uint8)
    uv = yuv[:, :, :, 1:].reshape(n, h // 2, 2, w // 2, 2, 2).mean((2, 4))
    uv = np.clip(np.rint(uv + 128.0), 0, 255).astype(np.uint8)
    out[:, h:, : w // 2] = uv[..., 0]
    out[:, h:, w // 2:] = uv[..., 1]
    return out


def yuv420_to_rgb_reference(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host (numpy, float32) reference of :func:`_yuv420_unpack`: packed
    ``[N, H + H//2, W]`` -> float32 [0, 1] RGB ``[N, H, W, 3]``, the same
    operations in the same order."""
    packed = np.asarray(packed)
    y = packed[:, :h, :].astype(np.float32)
    u = packed[:, h:, : w // 2].astype(np.float32) - 128.0
    v = packed[:, h:, w // 2:].astype(np.float32) - 128.0
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2)
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2)
    r = y + np.float32(1.402) * v
    g = y - np.float32(0.344136) * u - np.float32(0.714136) * v
    b = y + np.float32(1.772) * u
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0.0, 255.0) / np.float32(255.0)


def _yuv420_unpack(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Device side of the yuv420 wire: nearest-neighbour chroma upsample and
    BT.601 to [0, 1] float RGB ``[N, H, W, 3]``.  One eager operation a
    step, in the order of :func:`yuv420_to_rgb_reference` (no multiply-add
    is fused), and the division by 255 through ``div_exact``, so the result
    equals the reference bit for bit on any device."""
    y = packed[:, :h, :].to(torch.float32)
    u = packed[:, h:, : w // 2].to(torch.float32) - 128.0
    v = packed[:, h:, w // 2:].to(torch.float32) - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    rgb = torch.stack([r, g, b], dim=-1)
    return div_exact(torch.clamp(rgb, 0.0, 255.0), 255.0)


_WIRES = ("f32", "u8", "yuv420")


class Predictor:
    """Detector behind fixed batch buckets.

    Args:
      cfg: model config (``input_size`` fixes the served image shape).
      model: a :class:`FasterRCNN` on its serving device.
      batch_sizes: bucket sizes, any order.  A request runs as the
        cheapest bucket sequence (:meth:`_plan`).
      mesh: a :class:`~.parallel.mesh.Mesh` over devices of this process
        (the JAX Predictor is single-controller too): one replica of the
        weights a data index, on the first device of its row of the grid
        (``model``'s own where it already lies), and each bucket whose size
        the data axis divides runs its rows in equal blocks, one a replica,
        the outputs concatenated in order; other buckets run on the first
        replica.  A model axis splits nothing: the parameters stay
        replicated and a bucket splits over ``data`` only, as the JAX
        package's ``Predictor`` shards it without ``spatial``.
      spatial: with a ``mesh`` whose model axis divides the image height,
        and not on the yuv420 wire (its planes stack luma and chroma rows),
        each bucket the data axis divides is also split by image rows over
        ``model``, as the JAX package's ``P("data", "model")``: one worker
        thread a device of the grid, each with its own copy of the weights,
        runs the predict on its rows: ``FasterRCNN.features`` exchanges the
        halos with the others of its data index through the in-process
        transport of ``parallel/spatial.py`` and gathers the maps onto the
        data index's first device, whose worker runs the heads and answers.
        Other buckets run as without ``spatial``.
      int8_scales: per-conv input absmax from :func:`quantize.calibrate`;
        the dense convs listed run in int8 (``quantize.quantized``).
      calibrate: time every bucket (5 runs on host inputs, outputs fetched,
        the median kept) and plan by those costs instead of the size
        heuristic.
      wire: ``"f32"`` ([0, 1] float images), ``"u8"`` ([0, 255] uint8,
        converted on the device: 4x fewer host->device bytes) or
        ``"yuv420"`` (uint8 RGB packed on the host by
        :func:`rgb_to_yuv420`, or planes already packed; 8x fewer bytes).
    """

    # per-dispatch overhead in image-equivalents of the size heuristic
    _DISPATCH_OVERHEAD = 4

    def __init__(self, cfg: Config, model: FasterRCNN,
                 batch_sizes: Sequence[int] = (1, 8, 16), mesh=None,
                 spatial: bool = False, int8_scales: Mapping | None = None,
                 calibrate: bool = False, wire: str = "f32"):
        from two_stage_object_detection_tpu_torch.parallel.mesh import (
            Mesh, replicate)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and mesh.group is not None:
            raise ValueError("Predictor serves from one process: pass a mesh "
                             "over devices of this process")
        if wire not in _WIRES:
            raise ValueError(f"wire must be one of {_WIRES}, got {wire!r}")
        if cfg.mask_head and (spatial or int8_scales):
            raise ValueError("mask_head=True serves neither spatial=True nor "
                             "int8_scales: the mask head has no such route")
        if spatial:
            check_route(cfg.backbone, "spatial")
        if int8_scales:
            check_route(cfg.backbone, "int8")
        h, w = cfg.input_size
        if wire == "yuv420" and (h % 2 or w % 2):
            raise ValueError(f"wire='yuv420' needs even input_size, got "
                             f"{(h, w)}")
        self.cfg = cfg
        self.model = model
        n_model = 1 if mesh is None else mesh.shape["model"]
        self.spatial = (spatial and n_model > 1 and h % n_model == 0
                        and wire != "yuv420")
        if self.spatial:
            # a copy of the weights a worker, even where the grid repeats a
            # device: each copy's `spatial` names its worker's shard
            self._grid = [copy.deepcopy(model).to(d) for d in mesh.devices]
            self._n_data, self._n_model = mesh.shape["data"], n_model
            self._workers = concurrent.futures.ThreadPoolExecutor(
                len(self._grid), thread_name_prefix="spatial-rows")
        self.replicas = [model] if mesh is None else replicate(model, mesh)
        self.wire = wire
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(f"need positive batch sizes, got {batch_sizes}")
        self._int8 = dict(int8_scales) if int8_scales else None
        # wire shape and dtype of ONE request image
        self._wire_shape = (h + h // 2, w) if wire == "yuv420" else (h, w, 3)
        self._wire_np = np.float32 if wire == "f32" else np.uint8
        self._copy_streams = [torch.cuda.Stream(m.device)
                              if m.device.type == "cuda" else None
                              for m in self.replicas]
        self._plan_memo = {}
        self._bucket_ms = None
        if calibrate:
            self._bucket_ms = {}
            for b in self.batch_sizes:
                imgs = np.zeros((b, *self._wire_shape), self._wire_np)
                self._fetch(self._enqueue(b, imgs))               # warm
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    self._fetch(self._enqueue(b, imgs))
                    times.append(time.perf_counter() - t0)
                self._bucket_ms[b] = sorted(times)[len(times) // 2] * 1e3

    @classmethod
    def from_jax_variables(cls, cfg: Config, params: Mapping,
                           batch_stats: Mapping, device=None,
                           **kw) -> "Predictor":
        """Build a predictor from the JAX package's flax variables (nested
        dicts of numpy arrays)."""
        from two_stage_object_detection_tpu_torch.utils.jax_weights import (
            load_jax_variables)
        model = FasterRCNN(cfg, device=device)
        load_jax_variables(model, params, batch_stats)
        return cls(cfg, model, **kw)

    @classmethod
    def from_checkpoint(cls, weights_dir: str, cfg: Config, name: str = None,
                        device=None, **kw) -> "Predictor":
        """Serve the parameters and batch-norm statistics of the port's
        ``FasterRCNNTrainer_{best,last}`` checkpoint (``name``, default
        best) under ``weights_dir``; ``kw`` goes to the constructor.  Raises
        ``FileNotFoundError`` when there is none."""
        from two_stage_object_detection_tpu_torch.nets.trainer import (
            create_train_state)
        from two_stage_object_detection_tpu_torch.utils import (
            checkpoint as ckpt)
        model, state = create_train_state(cfg, device=device)
        if ckpt.restore_checkpoint(weights_dir, state, name=name or ckpt.BEST,
                                   params_only=True) is None:
            raise FileNotFoundError(
                f"no checkpoint {name or ckpt.BEST!r} under {weights_dir!r}")
        return cls(cfg, model, **kw)

    # ------------------------------------------------------------ dispatch
    def _plan(self, n: int):
        """Cheapest bucket sequence covering ``n`` images: minimises the
        buckets' measured milliseconds (``calibrate=True``), else padded
        images plus a fixed per-dispatch overhead (9 images with buckets
        (1, 8, 16) run as 8 + 1, 7 as one padded 8).  Memoised per
        instance."""
        hit = self._plan_memo.get(n)
        if hit is not None:
            return hit
        best = [0.0] + [float("inf")] * n
        choice = [0] * (n + 1)
        for r in range(1, n + 1):
            for b in self.batch_sizes:
                if self._bucket_ms is not None:
                    c = self._bucket_ms[b] + best[max(r - b, 0)]
                else:
                    c = self._DISPATCH_OVERHEAD + b + best[max(r - b, 0)]
                if c < best[r]:
                    best[r], choice[r] = c, b
        plan = []
        r = n
        while r > 0:
            plan.append(choice[r])
            r -= choice[r]
        self._plan_memo[n] = tuple(plan)
        return self._plan_memo[n]

    def _to_float(self, x: torch.Tensor) -> torch.Tensor:
        """The wire's conversion on the device: [0, 1] float images."""
        if self.wire == "u8":
            return div_exact(x.to(torch.float32), 255.0)
        if self.wire == "yuv420":
            return _yuv420_unpack(x, *self.cfg.input_size)
        return x

    def _int8_on(self, models) -> contextlib.ExitStack:
        """The int8 convs of ``models`` switched on (each module once)."""
        stack = contextlib.ExitStack()
        if self._int8 is not None:
            from two_stage_object_detection_tpu_torch.quantize import (
                quantized)
            for m in {id(m): m for m in models}.values():
                stack.enter_context(quantized(m, self._int8))
        return stack

    def _predict(self, model: FasterRCNN, x: torch.Tensor):
        """The wire's conversion on the device, then ``model``'s predict; a
        Mask R-CNN's masks leave it as float16 (half the bytes to the host)."""
        with self._int8_on([model]):
            res = model.predict(self._to_float(x))
        if res is None or len(res) == len(FIELDS):
            return res
        return (*res[:4], res[4].half())

    def _shard_predict(self, model: FasterRCNN, x: torch.Tensor):
        """One worker of a spatial bucket: ``model``'s predict on its shard's
        rows of ``x`` (its data index's images, host memory).  The lead
        shard's outputs (on the card copied back as in :meth:`_enqueue`);
        the others', None."""
        dev = model.device
        try:
            with torch.inference_mode(), (
                    torch.cuda.device(dev) if dev.type == "cuda"
                    else contextlib.nullcontext()):
                x = model.spatial.shard(*self.cfg.input_size) \
                    .own_image_rows(x)
                res = self._predict(model, x.to(dev, non_blocking=True))
                if res is None or dev.type != "cuda":
                    return res, None
                return (tuple(t.to("cpu", non_blocking=True) for t in res),
                        torch.cuda.current_stream(dev).record_event())
        except BaseException:
            model.spatial.transport.group.abort()   # release the others
            raise

    def _enqueue_spatial(self, bucket: int, host: torch.Tensor):
        """Start a spatial bucket run on ``host`` (the padded bucket): each
        data index's images over its row of the grid, one worker thread a
        device (a new group of shards a bucket, so a failed worker leaves
        no broken barrier behind); each data index's lead worker's
        outputs."""
        from two_stage_object_detection_tpu_torch.parallel import spatial
        nd, nm = self._n_data, self._n_model
        rows = bucket // nd
        futures = []
        for d in range(nd):
            group = spatial.ThreadGroup(nm)
            for m in range(nm):
                model = self._grid[d * nm + m]
                model.spatial = spatial.SpatialAxis(group.transport(m))
                futures.append(self._workers.submit(
                    self._shard_predict, model,
                    host[d * rows:(d + 1) * rows]))
        return [f.result() for f in futures][::nm]

    def _enqueue(self, bucket: int, chunk: np.ndarray):
        """Start one bucket run on ``chunk`` (at most ``bucket`` wire
        images, padded here): ``(take, [(outputs, event)] a replica)``.  On
        the card the chunk is staged in pinned memory, each replica's rows
        copied on its side stream, and the outputs are copied back
        asynchronously into pinned memory; they are valid once their
        ``event`` has completed."""
        with annotate("tsod.enqueue"):
            take = chunk.shape[0]
            pinned = any(s is not None for s in self._copy_streams)
            host = torch.empty((bucket, *self._wire_shape),
                               dtype=torch.float32 if self.wire == "f32"
                               else torch.uint8, pin_memory=pinned)
            host[:take] = torch.from_numpy(np.ascontiguousarray(chunk))
            if take < bucket:
                host[take:] = 0
                if self.wire == "yuv420":
                    host[take:, self.cfg.input_size[0]:] = 128   # zero chroma
            if self.spatial and bucket % self._n_data == 0:
                return take, self._enqueue_spatial(bucket, host)
            n = len(self.replicas) if bucket % len(self.replicas) == 0 else 1
            rows = bucket // n
            parts = []
            for model, stream, x in zip(self.replicas, self._copy_streams,
                                        host.split(rows)):
                if stream is None:
                    parts.append((self._predict(model, x), None))
                    continue
                dev = model.device
                # the kernels' ctypes launches go to the current device
                with torch.cuda.device(dev):
                    compute = torch.cuda.current_stream(dev)
                    with torch.cuda.stream(stream):
                        x = x.to(dev, non_blocking=True)
                    compute.wait_event(stream.record_event())
                    # x was allocated on the copy stream
                    x.record_stream(compute)
                    res = self._predict(model, x)
                    parts.append((tuple(t.to("cpu", non_blocking=True)
                                        for t in res), compute.record_event()))
            return take, parts

    @staticmethod
    def _fetch(pending):
        with annotate("tsod.fetch"):
            take, parts = pending
            for _, done in parts:
                if done is not None:
                    done.synchronize()
            return tuple(torch.cat(ts)[:take].numpy()
                         for ts in zip(*(outs for outs, _ in parts)))

    def __call__(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """Detect on a request of any ``N >= 1`` images in the wire's
        layout (see :meth:`_to_wire`).

        Returns host arrays ``boxes [N, D, 4]``, ``scores [N, D]``,
        ``labels [N, D]`` (1-based classes) and ``valid [N, D]`` with
        ``D = cfg.max_detections``; with ``cfg.mask_head`` also ``masks [N,
        D, M, M]`` float16 (``M = 2 * cfg.mask_roi_size``, 28): the
        probability of each bin of a detection's box, on a grid of ``M x M``
        equal bins over the box, of belonging to the object (its class's
        channel), zero where ``valid`` is False (:func:`paste_masks` puts
        them into the image).
        """
        with annotate("tsod.request"):
            with annotate("tsod.wire"):
                images = self._to_wire(np.asarray(images))
            n = images.shape[0]
            # at most 2 buckets in flight: the oldest one's outputs are
            # fetched before a third is enqueued, which bounds the device
            # memory a large request holds
            outs, pending = [], []
            i = 0
            for bucket in self._plan(n):
                if len(pending) == 2:
                    outs.append(self._fetch(pending.pop(0)))
                take = min(n - i, bucket)
                pending.append(self._enqueue(bucket, images[i:i + take]))
                i += take
            outs += [self._fetch(p) for p in pending]
            cat = tuple(np.concatenate(parts) for parts in zip(*outs))
            return dict(zip(FIELDS_WITH_MASKS, cat))

    def _to_wire(self, images: np.ndarray) -> np.ndarray:
        """Validate a request and put it in the wire layout ``[N,
        *wire_shape]``.

        The f32 and u8 wires take ``[N, H, W, 3]`` (or one ``[H, W, 3]``)
        images.  The yuv420 wire takes uint8 RGB the same way (packed here
        on the host), or packed ``[N, H + H//2, W]`` planes, so that
        :class:`DynamicBatcher` packs once in the submitting thread.
        """
        h, w = self.cfg.input_size
        if self.wire == "yuv420":
            if images.ndim == 3 and images.shape == (h, w, 3):
                images = images[None]
            if images.ndim == 4 and images.shape[1:] == (h, w, 3):
                if images.dtype != np.uint8:
                    raise ValueError(
                        "wire='yuv420' Predictor takes uint8 [0,255] RGB "
                        f"(or packed planes), got {images.dtype}")
                return rgb_to_yuv420(images)
            if images.ndim == 2 and images.shape == self._wire_shape:
                images = images[None]
            if images.ndim == 3 and images.shape[1:] == self._wire_shape:
                if images.dtype != np.uint8:
                    raise ValueError("packed yuv420 planes must be uint8")
                if images.shape[0] < 1:
                    raise ValueError("a request needs at least one image")
                return images
            raise ValueError(
                f"expected [N, {h}, {w}, 3] uint8 RGB or packed "
                f"[N, {h + h // 2}, {w}] planes, got {images.shape}; "
                "serving shapes are static — resize/letterbox on ingest")
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[1:] != (h, w, 3):
            raise ValueError(
                f"expected [N, {h}, {w}, 3] images, got {images.shape}; "
                "serving shapes are static — resize/letterbox on ingest")
        if images.shape[0] < 1:
            raise ValueError("a request needs at least one image")
        if self.wire == "u8":
            if images.dtype != np.uint8:
                raise ValueError("wire='u8' Predictor takes uint8 [0,255] images")
            return images
        if images.dtype == np.uint8:
            raise ValueError("f32 Predictor takes [0,1] float images "
                             "(use wire='u8' for uint8 requests)")
        return images.astype(np.float32, copy=False)


def paste_masks(boxes, masks, img_size, threshold: float = 0.5):
    """Each detection's ``M x M`` mask pasted into the image, as
    detectron2's ``paste_masks_in_image`` does: ``boxes [..., D, 4]`` and
    ``masks [..., D, M, M]`` (tensors on any device, or numpy) -> ``[..., D,
    H, W]`` bool on the masks' device, ``img_size = (H, W)``.  Each pixel
    centre is placed in its box's mask grid and the mask read there
    bilinearly (``F.grid_sample``, ``align_corners=False``, zero outside),
    then held to ``threshold``.  ``H * W`` bytes a detection."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    masks = torch.as_tensor(masks).to(torch.float32)
    boxes = boxes.to(masks.device)
    lead, (m1, m2) = masks.shape[:-2], masks.shape[-2:]
    b = boxes.reshape(-1, 4)
    h, w = img_size
    ys = torch.arange(h, dtype=torch.float32, device=masks.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=masks.device) + 0.5
    gy = (ys[None] - b[:, 1:2]) / (b[:, 3:4] - b[:, 1:2]) * 2 - 1   # [N, H]
    gx = (xs[None] - b[:, 0:1]) / (b[:, 2:3] - b[:, 0:1]) * 2 - 1   # [N, W]
    n = b.shape[0]
    grid = torch.stack([gx[:, None, :].expand(n, h, w),
                        gy[:, :, None].expand(n, h, w)], dim=-1)
    img = torch.nn.functional.grid_sample(
        masks.reshape(n, 1, m1, m2), grid, align_corners=False)
    return (img[:, 0] >= threshold).reshape(*lead, h, w)


class DynamicBatcher:
    """Cross-request dynamic batching on top of :class:`Predictor`.

    :meth:`submit` validates a request and puts it in the wire layout in
    the submitting thread, enqueues it and returns a
    ``concurrent.futures.Future``.  One worker thread flushes the queue
    when the pending images fill ``max_batch`` (default: the largest
    bucket) or the oldest request has waited ``max_wait_ms``: it
    concatenates the pending images, runs the predictor once (its plan
    picks the buckets for the combined size) and slices the results back
    per request.  Cancelled futures drop out of a flush.  ``submit`` may be
    called from any number of threads; all device work happens on the
    worker thread.  :meth:`close` (or leaving the context) flushes what is
    pending, then stops the worker.
    """

    def __init__(self, predictor: Predictor, max_wait_ms: float = 5.0,
                 max_batch: int = None):
        self._pred = predictor
        self._max_wait = max_wait_ms / 1e3
        self._max_batch = max_batch or max(predictor.batch_sizes)
        self._lock = threading.Condition()
        self._queue = collections.deque()   # (images, n, future, t0)
        self._pending = 0                   # images queued, under _lock
        self._closing = False
        self.flushes = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="DynamicBatcher")
        self._worker.start()

    def submit(self, images: np.ndarray) -> concurrent.futures.Future:
        """Enqueue ``[N, H, W, 3]`` (or ``[H, W, 3]``) images, or packed
        yuv420 planes; the future resolves to the dict the predictor would
        return for these images alone."""
        images = self._pred._to_wire(np.asarray(images))
        fut = concurrent.futures.Future()
        with self._lock:
            if self._closing:
                raise RuntimeError("DynamicBatcher is closed")
            self._queue.append((images, images.shape[0], fut,
                                time.perf_counter()))
            self._pending += images.shape[0]
            self._lock.notify()
        return fut

    def close(self):
        """Flush pending requests and stop the worker."""
        with self._lock:
            self._closing = True
            self._lock.notify()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self):
        while True:
            with self._lock:
                while True:
                    if self._queue:
                        oldest = self._queue[0][3]
                        full = self._pending >= self._max_batch
                        timeout = oldest + self._max_wait - time.perf_counter()
                        if full or self._closing or timeout <= 0:
                            break
                        self._lock.wait(timeout)
                    elif self._closing:
                        return
                    else:
                        self._lock.wait()
                batch, self._queue = list(self._queue), collections.deque()
                self._pending = 0
            self._flush(batch)

    def _flush(self, batch):
        # claim each future first: set_result on a future the client
        # cancelled would raise and kill this, the only, worker thread
        live = [b for b in batch if b[2].set_running_or_notify_cancel()]
        if not live:
            return
        self.flushes += 1
        try:
            out = self._pred(np.concatenate([b[0] for b in live]))
        except Exception as e:                              # noqa: BLE001
            for _, _, fut, _ in live:
                fut.set_exception(e)
            return
        i = 0
        for _, n, fut, _ in live:
            fut.set_result({k: v[i:i + n] for k, v in out.items()})
            i += n


# ------------------------------------------------------------------ export
class _PredictProgram(torch.nn.Module):
    """What is exported: ``images [B, H, W, 3]`` f32 in [0, 1] ->
    ``(boxes, scores, labels, valid)``, the model's ``predict``."""

    def __init__(self, model: FasterRCNN):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        return self.model.predict(images)


def export_program(cfg: Config, model: FasterRCNN, path: str,
                   batch_size: int = 1, portable: bool = True) -> int:
    """``torch.export`` the predict path of ``model`` (weights included)
    at ``batch_size`` images of ``cfg.input_size`` and save it to ``path``;
    returns the artifact's bytes.

    ``portable=True`` exports a copy of the model built with
    ``pallas="off", pallas_roi=False``: plain PyTorch only, an artifact
    that :func:`load_exported` runs on the CPU or the card.
    ``portable=False`` exports ``model`` as it is; on the card its kernels
    stay in the graph as the port's custom ops (``tsod::*``), so the
    artifact runs only on a CUDA device, in a process that has imported
    this package's ops (:func:`load_exported` does).  Either program runs
    the backbone unfolded, batch norm as a pass of its own: eager predict
    on the card folds it (``models/layers.py:fold_route`` says why a traced
    program does not).
    """
    model.eval()
    if portable:
        plain = FasterRCNN(cfg.replace(pallas="off", pallas_roi=False),
                           device=model.device)
        plain.load_state_dict(model.state_dict())
        model = plain
    h, w = cfg.input_size
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                          device=model.device)
    program = torch.export.export(_PredictProgram(model), (example,),
                                  strict=False)
    program.example_inputs = None    # the artifact holds no example images
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_exported(path: str, device=None):
    """Load an :func:`export_program` artifact -> callable ``images [B, H,
    W, 3]`` (a tensor on the program's device) -> ``(boxes, scores, labels,
    valid)``.  ``device`` moves a portable program (e.g. to ``"cpu"``)."""
    # the custom ops a kernel-keeping artifact calls are registered when
    # their modules are imported
    from two_stage_object_detection_tpu_torch.ops import (  # noqa: F401
        proposals, roi_pool_max, windowed_align)
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
    module = program.module()

    @torch.no_grad()
    def run(images: torch.Tensor):
        return tuple(module(images))

    return run
