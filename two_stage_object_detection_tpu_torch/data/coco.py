"""COCO-format annotation ingest (the JAX package's ``data/coco.py``).

Equivalent of reference ``dataset/data_organise.py:9-114`` but as an explicit
function instead of import-time module globals, and with its sampling quirk
fixed: the reference draws random indices and then ignores them, always taking
the *first* N images (``data_organise.py:51-55``) — here the sampled indices
are actually used (deterministically seeded).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class CocoIndex:
    """Parsed dataset: one record per image with xyxy boxes + class indices."""

    records: List[dict]                       # {image_path, boxes, labels, image_id}
    class_index_to_name: Dict[int, str]
    class_index_to_category_id: Dict[int, int]
    category_id_to_class_index: Dict[int, int]

    def __len__(self):
        return len(self.records)

    @property
    def num_classes(self) -> int:
        return len(self.class_index_to_name)


def load_coco(ann_path: str, image_dir: str, ratio: float = 1.0,
              seed: Optional[int] = 0, drop_empty: bool = True) -> CocoIndex:
    """Load a COCO ``instances_*.json`` into a :class:`CocoIndex`.

    Args:
      ann_path: annotation JSON path.
      image_dir: directory holding the image files.
      ratio: fraction of images to keep (reference ``train_ratio``/``eval_ratio``).
      seed: sampling seed (None -> keep the first N, reference behaviour).
      drop_empty: drop images without annotations
        (reference ``clean_data``, ``data_organise.py:81-96``).
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

    # attach annotations, xywh -> xyxy (reference insert_annotations,
    # data_organise.py:63-79)
    for ann in data["annotations"]:
        rec = by_id.get(ann["image_id"])
        if rec is None:
            continue
        x, y, w, h = ann["bbox"]
        rec["boxes"].append([x, y, x + w, y + h])
        rec["labels"].append(category_id_to_class_index[ann["category_id"]])

    records = []
    for rec in by_id.values():
        if drop_empty and not rec["boxes"]:
            continue
        rec["boxes"] = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
        rec["labels"] = np.asarray(rec["labels"], np.int32)
        records.append(rec)

    return CocoIndex(records, class_index_to_name,
                     class_index_to_category_id, category_id_to_class_index)
