"""Serving: batch buckets and the f32 / u8 request wires.

The counterpart of the JAX package's ``serving.py:Predictor``.  A request
of ``n`` images is cut into a sequence of fixed batch buckets by the same
size heuristic (:meth:`Predictor._plan`), each chunk padded up to its
bucket, and the results truncated back.  Fixed buckets keep the set of
shapes the device sees small.  ``__call__`` returns a dict of numpy
``boxes/scores/labels/valid``.

:meth:`Predictor.from_checkpoint` loads the port's own checkpoints
(``utils/checkpoint.py``: ``torch.save`` files under
``FasterRCNNTrainer_{best,last}``); :meth:`Predictor.from_jax_variables`
takes the JAX package's flax variables as numpy trees.

Not ported yet: the yuv420 wire, ``calibrate``, ``mesh``/``spatial``,
``int8_scales``, ``DynamicBatcher``, export, and reading the JAX package's
Orbax checkpoints or the reference's ``.pth`` files directly (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.ops.geometry import div_exact

FIELDS = ("boxes", "scores", "labels", "valid")


class Predictor:
    """Detector behind fixed batch buckets.

    Args:
      cfg: model config (``input_size`` fixes the served image shape).
      model: a :class:`FasterRCNN` on its serving device.
      batch_sizes: bucket sizes, any order.  A request runs as the
        cheapest bucket sequence under a fixed per-dispatch overhead.
      wire: ``"f32"`` ([0, 1] float images) or ``"u8"`` ([0, 255] uint8
        images, converted to floats on the device: 4x fewer host->device
        bytes).
    """

    # per-dispatch overhead in image-equivalents of the size heuristic
    _DISPATCH_OVERHEAD = 4

    def __init__(self, cfg: Config, model: FasterRCNN,
                 batch_sizes: Sequence[int] = (1, 8, 16), wire: str = "f32"):
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r} "
                             "(yuv420 is not ported yet)")
        self.cfg = cfg
        self.model = model
        self.wire = wire
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(f"need positive batch sizes, got {batch_sizes}")
        self._plan_memo = {}

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
        best) under ``weights_dir``; raises ``FileNotFoundError`` when there
        is none."""
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

    def _plan(self, n: int):
        """Cheapest bucket sequence covering ``n`` images: minimises padded
        images plus a fixed per-dispatch overhead (9 images with buckets
        (1, 8, 16) run as 8 + 1, 7 as one padded 8)."""
        hit = self._plan_memo.get(n)
        if hit is not None:
            return hit
        best = [0.0] + [float("inf")] * n
        choice = [0] * (n + 1)
        for r in range(1, n + 1):
            for b in self.batch_sizes:
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

    def __call__(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """Detect on ``[N, H, W, 3]`` images (any ``N >= 1``).

        Returns host arrays ``boxes [N, D, 4]``, ``scores [N, D]``,
        ``labels [N, D]`` (1-based classes) and ``valid [N, D]`` with
        ``D = cfg.max_detections``.
        """
        images = self._to_wire(np.asarray(images))
        n = images.shape[0]
        dev = self.model.device
        outs = []
        i = 0
        for bucket in self._plan(n):
            take = min(n - i, bucket)
            chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + take]))
            if take < bucket:
                pad = torch.zeros((bucket - take, *chunk.shape[1:]),
                                  dtype=chunk.dtype)
                chunk = torch.cat([chunk, pad])
            x = chunk.to(dev, non_blocking=True)
            if self.wire == "u8":
                x = div_exact(x.to(torch.float32), 255.0)
            res = self.model.predict(x)
            outs.append(tuple(t[:take] for t in res))
            i += take
        cat = [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]
        return dict(zip(FIELDS, cat))

    def _to_wire(self, images: np.ndarray) -> np.ndarray:
        """Validate a request: ``[N, H, W, 3]`` (or one ``[H, W, 3]``)."""
        h, w = self.cfg.input_size
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
