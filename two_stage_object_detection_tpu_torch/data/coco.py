"""COCO-format annotation ingest (the JAX package's ``data/coco.py``).

Equivalent of reference ``dataset/data_organise.py:9-114`` but as an explicit
function instead of import-time module globals, and with its sampling quirk
fixed: the reference draws random indices and then ignores them, always taking
the *first* N images (``data_organise.py:51-55``) — here the sampled indices
are actually used (deterministically seeded).

For Mask R-CNN (``load_coco(polygons=True)``) each record also holds its
objects' ``segmentation`` polygons, and :func:`pack_polygon` lays one
object's rings out as the fixed ``[V, 2]`` vertices and ``[V]`` edge flags
the model trains on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CocoIndex:
    """Parsed dataset: one record per image with xyxy boxes + class indices."""

    records: List[dict]     # {image_path, boxes, labels, image_id[, polys, size]}
    class_index_to_name: Dict[int, str]
    class_index_to_category_id: Dict[int, int]
    category_id_to_class_index: Dict[int, int]

    def __len__(self):
        return len(self.records)

    @property
    def num_classes(self) -> int:
        return len(self.class_index_to_name)


def load_coco(ann_path: str, image_dir: str, ratio: float = 1.0,
              seed: Optional[int] = 0, drop_empty: bool = True,
              polygons: bool = False) -> CocoIndex:
    """Load a COCO ``instances_*.json`` into a :class:`CocoIndex`.

    Args:
      ann_path: annotation JSON path.
      image_dir: directory holding the image files.
      ratio: fraction of images to keep (reference ``train_ratio``/``eval_ratio``).
      seed: sampling seed (None -> keep the first N, reference behaviour).
      drop_empty: drop images without annotations
        (reference ``clean_data``, ``data_organise.py:81-96``).
      polygons: also keep each object's ``segmentation`` polygons as
        ``polys`` (a list a box: its rings, ``[n, 2]`` float32 arrays of 3
        or more vertices) and the image's ``size`` ``(height, width)``
        from the file.  RLE and crowd objects keep no ring, as Detectron
        trains no mask on them.
    """
    with open(ann_path, "r") as f:
        data = json.load(f)

    # category id <-> contiguous class index <-> name
    # (reference init_category_id_and_class_index, data_organise.py:35-41)
    cats = data["categories"]
    class_index_to_name = {i: c["name"] for i, c in enumerate(cats)}
    class_index_to_category_id = {i: c["id"] for i, c in enumerate(cats)}
    category_id_to_class_index = {c["id"]: i for i, c in enumerate(cats)}

    images = data["images"]
    num = max(int(len(images) * ratio), 1) if ratio < 1.0 else len(images)
    if seed is None:
        chosen = list(range(num))
    else:
        rng = random.Random(seed)
        chosen = rng.sample(range(len(images)), num)

    by_id = {}
    for i in chosen:
        img = images[i]
        by_id[img["id"]] = {
            "image_path": os.path.join(image_dir, img["file_name"]),
            "image_id": img["id"],
            "boxes": [],
            "labels": [],
        }
        if polygons:
            by_id[img["id"]].update(polys=[],
                                    size=(img["height"], img["width"]))

    # attach annotations, xywh -> xyxy (reference insert_annotations,
    # data_organise.py:63-79)
    for ann in data["annotations"]:
        rec = by_id.get(ann["image_id"])
        if rec is None:
            continue
        x, y, w, h = ann["bbox"]
        rec["boxes"].append([x, y, x + w, y + h])
        rec["labels"].append(category_id_to_class_index[ann["category_id"]])
        if polygons:
            seg = ann.get("segmentation")
            rings = [] if ann.get("iscrowd") or not isinstance(seg, list) \
                else [np.asarray(r, np.float32).reshape(-1, 2) for r in seg
                      if len(r) >= 6]
            rec["polys"].append(rings)

    records = []
    for rec in by_id.values():
        if drop_empty and not rec["boxes"]:
            continue
        rec["boxes"] = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
        rec["labels"] = np.asarray(rec["labels"], np.int32)
        records.append(rec)

    return CocoIndex(records, class_index_to_name,
                     class_index_to_category_id, category_id_to_class_index)


def _ring_sizes(ns: Sequence[int], v: int) -> List[int]:
    """Vertices kept of each ring (0: the ring is dropped) so that every
    kept ring, closed by its first vertex again, fits ``v`` slots: all of
    them where they fit, else the largest rings first, each resampled to a
    share of the room proportional to its size (3 at least)."""
    keep = sorted(range(len(ns)), key=lambda i: -ns[i])
    while keep and 4 * len(keep) > v:
        keep.pop()
    room = v - len(keep)
    total = sum(ns[i] for i in keep)
    k = [0] * len(ns)
    for i in keep:
        k[i] = ns[i] if total <= room else max(3, room * ns[i] // total)
    while sum(k) > room:
        k[max(keep, key=lambda i: k[i])] -= 1
    return k


def pack_polygon(rings: Sequence[np.ndarray], v: int):
    """One object's rings as ``(vertices [v, 2] float32, edges [v] bool)``:
    each ring's vertices, then its first vertex again, ring after ring,
    zeros after; ``edges[j]`` is True where vertex ``j`` to ``j + 1`` is an
    edge of a ring.  Rings that do not fit are resampled uniformly along
    their vertex lists (:func:`_ring_sizes`)."""
    verts = np.zeros((v, 2), np.float32)
    edges = np.zeros((v,), bool)
    at = 0
    for ring, k in zip(rings, _ring_sizes([len(r) for r in rings], v)):
        if not k:
            continue
        pick = ring[(np.arange(k) * len(ring)) // k]
        verts[at:at + k] = pick
        verts[at + k] = pick[0]
        edges[at:at + k] = True
        at += k + 1
    return verts, edges
