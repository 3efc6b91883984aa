"""Synthetic COCO-format dataset generation (test fixture + benchmarks).

Draws axis-aligned coloured rectangles on plain backgrounds and emits a
COCO ``instances_*.json`` + PNG images, so end-to-end train/eval/mAP paths
can be exercised hermetically (the reference ships no data and no fixtures —
SURVEY §4).

The port's copy of the JAX package's ``data/synthetic.py``: for the same
arguments it writes the same files, byte for byte.  With ``polygons=True``
(the port's own, for Mask R-CNN) each object is a star-convex polygon drawn
inside its rectangle instead, with its ``segmentation``.  PIL is imported
inside the function.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

_COLORS = [(220, 40, 40), (40, 200, 60), (50, 80, 230), (240, 200, 40),
           (160, 60, 220), (40, 210, 210)]


def generate_synthetic_coco(root: str, split: str = "train2017",
                            num_images: int = 8, num_classes: int = 3,
                            image_size: Tuple[int, int] = (160, 200),
                            max_boxes: int = 4, seed: int = 0,
                            fmt: str = "png",
                            box_frac: Tuple[float, float] = (0.125, 0.5),
                            polygons: bool = False):
    """Write ``root/{split}`` images + ``root/annotations/instances_{split}.json``.

    ``fmt``: "png" (lossless fixtures) or "jpg" (COCO-realistic decode cost
    for host-pipeline benchmarks).  ``box_frac``: box side range as a
    fraction of the image dims (small-object experiments use e.g.
    ``(0.03, 0.08)``).  ``polygons``: paint each object as a star-convex
    polygon of 6-12 vertices inside its rectangle (vertex ``k`` at angle
    ``2 pi (k + u) / n``, radius 0.55-1 of the half-sides, from the
    rectangle's centre), its ``bbox`` the polygon's bounds and its
    ``segmentation`` the one ring.  Returns ``(ann_path, image_dir)``.
    """
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    h, w = image_size
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        canvas = np.full((h, w, 3), rng.randint(180, 255, 3), np.uint8)
        n = rng.randint(1, max_boxes + 1)
        for _ in range(n):
            cls = int(rng.randint(num_classes))
            lo, hi = box_frac
            bw = rng.randint(max(int(w * lo), 4), max(int(w * hi), 5))
            bh = rng.randint(max(int(h * lo), 4), max(int(h * hi), 5))
            x = int(rng.randint(0, w - bw))
            y = int(rng.randint(0, h - bh))
            color = _COLORS[cls % len(_COLORS)]
            ann = {"id": ann_id, "image_id": img_id, "category_id": cls + 1,
                   "bbox": [float(x), float(y), float(bw), float(bh)],
                   "area": float(bw * bh), "iscrowd": 0}
            if polygons:
                k = int(rng.randint(6, 13))
                ang = 2 * np.pi * (np.arange(k) + rng.rand(k)) / k
                rad = rng.uniform(0.55, 1.0, k)
                px = x + bw / 2 + rad * np.cos(ang) * bw / 2
                py = y + bh / 2 + rad * np.sin(ang) * bh / 2
                ring = [float(round(v, 2)) for xy in zip(px, py) for v in xy]
                fill = Image.new("L", (w, h), 0)
                ImageDraw.Draw(fill).polygon(ring, fill=1)
                canvas[np.asarray(fill, bool)] = color
                x0, y0 = min(ring[0::2]), min(ring[1::2])
                ann.update(bbox=[x0, y0, max(ring[0::2]) - x0,
                                 max(ring[1::2]) - y0],
                           segmentation=[ring])
            else:
                canvas[y:y + bh, x:x + bw] = color
            annotations.append(ann)
            ann_id += 1
        fname = f"{img_id:012d}.{fmt}"
        Image.fromarray(canvas).save(os.path.join(img_dir, fname), quality=90)
        images.append({"id": img_id, "file_name": fname,
                       "height": h, "width": w})

    categories = [{"id": c + 1, "name": f"class_{c}", "supercategory": "synthetic"}
                  for c in range(num_classes)]
    ann_path = os.path.join(ann_dir, f"instances_{split}.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return ann_path, img_dir
