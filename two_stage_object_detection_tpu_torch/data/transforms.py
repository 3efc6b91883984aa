"""Joint image/box augmentations (host-side numpy + PIL).

Equivalent of reference ``dataset/transform.py:4-16`` (torchvision v2
Compose): photometric distort -> random hflip -> scale jitter -> resize to
600x600 -> sanitize boxes -> float32 [0, 1].  Boxes are transformed jointly
with the image; outputs are HWC float32 (NHWC batching downstream).  Given ``polys``
(Mask R-CNN: one list of ``[k, 2]`` float32 rings a box, as
``load_coco(polygons=True)`` gives them), the geometric steps move every
vertex as they move the box corners, sanitize keeps the kept boxes' rings,
and the polygons come back as one more output.

The JAX package's ``data/transforms.py``, call for call: the same numpy
draws from the same ``RandomState``, the same native resize and the same PIL
fallback, so both packages produce the same pixels.  PIL is imported inside
the function that falls back to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def photometric_distort(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Brightness / contrast / saturation / hue jitter on float [0,1] HWC.

    Parameter ranges follow torchvision ``RandomPhotometricDistort`` defaults
    (brightness .875-1.125, contrast .5-1.5, saturation .5-1.5, hue +-.05).
    """
    img = img.copy()
    if rng.rand() < 0.5:
        img *= rng.uniform(0.875, 1.125)
    contrast_late = rng.rand() < 0.5
    if not contrast_late and rng.rand() < 0.5:
        mean = img.mean()
        img = (img - mean) * rng.uniform(0.5, 1.5) + mean
    if rng.rand() < 0.5:                       # saturation
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
        f = rng.uniform(0.5, 1.5)
        img = img * f + gray[..., None] * (1 - f)
    if rng.rand() < 0.5:                       # cheap hue jitter: channel roll mix
        delta = rng.uniform(-0.05, 0.05)
        shifted = np.roll(img, 1, axis=-1)
        img = img * (1 - abs(delta)) + shifted * abs(delta)
    if contrast_late and rng.rand() < 0.5:
        mean = img.mean()
        img = (img - mean) * rng.uniform(0.5, 1.5) + mean
    return np.clip(img, 0.0, 1.0)


def _move(polys, fn):
    """Each ring of each box through ``fn``."""
    return [[fn(r) for r in rings] for rings in polys]


def random_hflip(img: np.ndarray, boxes: np.ndarray,
                 rng: np.random.RandomState, p: float = 0.5, polys=None):
    if rng.rand() < p:
        w = img.shape[1]
        img = img[:, ::-1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if polys is not None:
            polys = _move(polys, lambda r: np.stack([w - r[:, 0], r[:, 1]], -1))
    return (img, boxes) if polys is None else (img, boxes, polys)


def resize(img: np.ndarray, boxes: np.ndarray, size: Tuple[int, int],
           polys=None):
    """Resize HWC float image (+boxes) to ``(H, W)``, antialiased bilinear.

    Uses the native C++ triangle-filter resize (``native/preprocess.cpp``)
    when built, PIL otherwise — both match torchvision v2
    ``Resize(antialias=True)`` semantics.
    """
    from two_stage_object_detection_tpu_torch.data import native

    h0, w0 = img.shape[:2]
    h1, w1 = size
    out = native.resize_f32(img, (h1, w1))
    if out is None:
        from PIL import Image
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        out = np.asarray(pil.resize((w1, h1), Image.BILINEAR), np.float32) / 255.0
    boxes = boxes * np.array([w1 / w0, h1 / h0, w1 / w0, h1 / h0], np.float32)
    if polys is None:
        return out, boxes
    return out, boxes, _move(polys, lambda r: r * np.array(
        [w1 / w0, h1 / h0], np.float32))


def scale_jitter(img: np.ndarray, boxes: np.ndarray,
                 rng: np.random.RandomState,
                 target: Tuple[int, int] = (600, 600),
                 scale_range: Tuple[float, float] = (0.8, 1.2), polys=None):
    """torchvision ``ScaleJitter``: resize to ``target * s`` for random ``s``."""
    s = rng.uniform(*scale_range)
    h = max(int(target[0] * s), 8)
    w = max(int(target[1] * s), 8)
    return resize(img, boxes, (h, w), polys)


def sanitize_boxes(boxes: np.ndarray, labels: np.ndarray, img_size,
                   min_size: float = 1.0, polys=None):
    """Clip to the image and drop degenerate boxes
    (torchvision ``SanitizeBoundingBoxes``); a dropped box's rings go with
    it, a kept one's are not clipped."""
    h, w = img_size
    boxes = boxes.copy()
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = ((boxes[:, 2] - boxes[:, 0]) >= min_size) & \
           ((boxes[:, 3] - boxes[:, 1]) >= min_size)
    if polys is None:
        return boxes[keep], labels[keep]
    return boxes[keep], labels[keep], [polys[i] for i in np.flatnonzero(keep)]


def train_transform(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    rng: np.random.RandomState,
                    size: Tuple[int, int] = (600, 600), polys=None):
    """Full training augmentation chain (reference ``transform.py:4-12``)."""
    rings = [[] for _ in boxes] if polys is None else polys
    img = photometric_distort(img, rng)
    img, boxes, rings = random_hflip(img, boxes, rng, polys=rings)
    img, boxes, rings = scale_jitter(img, boxes, rng, target=size, polys=rings)
    img, boxes, rings = resize(img, boxes, size, rings)
    boxes, labels, rings = sanitize_boxes(boxes, labels, size, polys=rings)
    return (img, boxes, labels) if polys is None else (img, boxes, labels, rings)


def eval_transform(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                   rng: Optional[np.random.RandomState] = None,
                   size: Tuple[int, int] = (600, 600), polys=None):
    """Eval chain: resize only (reference ``transform.py:14-16``)."""
    rings = [[] for _ in boxes] if polys is None else polys
    img, boxes, rings = resize(img, boxes, size, rings)
    boxes, labels, rings = sanitize_boxes(boxes, labels, size, polys=rings)
    return (img, boxes, labels) if polys is None else (img, boxes, labels, rings)
