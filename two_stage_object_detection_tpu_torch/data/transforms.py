"""Joint image/box augmentations (host-side numpy + PIL).

Equivalent of reference ``dataset/transform.py:4-16`` (torchvision v2
Compose): photometric distort -> random hflip -> scale jitter -> resize to
600x600 -> sanitize boxes -> float32 [0, 1].  Boxes are transformed jointly
with the image; outputs are HWC float32 (NHWC batching downstream).

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


def random_hflip(img: np.ndarray, boxes: np.ndarray,
                 rng: np.random.RandomState, p: float = 0.5):
    if rng.rand() < p:
        w = img.shape[1]
        img = img[:, ::-1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def resize(img: np.ndarray, boxes: np.ndarray, size: Tuple[int, int]):
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
    return out, boxes


def scale_jitter(img: np.ndarray, boxes: np.ndarray,
                 rng: np.random.RandomState,
                 target: Tuple[int, int] = (600, 600),
                 scale_range: Tuple[float, float] = (0.8, 1.2)):
    """torchvision ``ScaleJitter``: resize to ``target * s`` for random ``s``."""
    s = rng.uniform(*scale_range)
    h = max(int(target[0] * s), 8)
    w = max(int(target[1] * s), 8)
    return resize(img, boxes, (h, w))


def sanitize_boxes(boxes: np.ndarray, labels: np.ndarray, img_size,
                   min_size: float = 1.0):
    """Clip to the image and drop degenerate boxes
    (torchvision ``SanitizeBoundingBoxes``)."""
    h, w = img_size
    boxes = boxes.copy()
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = ((boxes[:, 2] - boxes[:, 0]) >= min_size) & \
           ((boxes[:, 3] - boxes[:, 1]) >= min_size)
    return boxes[keep], labels[keep]


def train_transform(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    rng: np.random.RandomState,
                    size: Tuple[int, int] = (600, 600)):
    """Full training augmentation chain (reference ``transform.py:4-12``)."""
    img = photometric_distort(img, rng)
    img, boxes = random_hflip(img, boxes, rng)
    img, boxes = scale_jitter(img, boxes, rng, target=size)
    img, boxes = resize(img, boxes, size)
    boxes, labels = sanitize_boxes(boxes, labels, size)
    return img, boxes, labels


def eval_transform(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                   rng: Optional[np.random.RandomState] = None,
                   size: Tuple[int, int] = (600, 600)):
    """Eval chain: resize only (reference ``transform.py:14-16``)."""
    img, boxes = resize(img, boxes, size)
    boxes, labels = sanitize_boxes(boxes, labels, size)
    return img, boxes, labels
