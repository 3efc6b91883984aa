"""Inference driver with visualisation.

The port's copy of the JAX package's ``infer.py``: pick N random eval
images, run the detector's true inference path, render GT (green) vs
predictions (red) to PNGs (reference ``multi_inference.py:21-179``, which
has to feed GT boxes into its trainer forward).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional

import numpy as np

from two_stage_object_detection_tpu_torch.config import Config, load_config
from two_stage_object_detection_tpu_torch.data.coco import load_coco
from two_stage_object_detection_tpu_torch.data.pipeline import DetectionDataset
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, predict_step)
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
from two_stage_object_detection_tpu_torch.utils.draw import draw_detections

log = logging.getLogger(__name__)


def multi_inference(num_inference: int = 5, cfg: Optional[Config] = None,
                    data_root: str = "data", weights_dir: str = "weights",
                    output_dir: str = "inference_results", seed: int = 0):
    """Render ``num_inference`` eval images with their detections; returns
    the PNG paths.  Uses the ``_best`` checkpoint, or random weights (with a
    warning) when there is none."""
    cfg = cfg or load_config()
    os.makedirs(output_dir, exist_ok=True)

    eval_idx = load_coco(
        os.path.join(data_root, "annotations", "instances_val2017.json"),
        os.path.join(data_root, "val2017"), ratio=cfg.eval_ratio)
    ds = DetectionDataset(eval_idx, cfg.input_size, cfg.max_gt_boxes,
                          train=False)

    _, state = create_train_state(cfg, seed=seed)
    if ckpt.restore_checkpoint(weights_dir, state, name=ckpt.BEST,
                               params_only=True) is not None:
        log.info("✅ Successfully loaded pretrained model")
    else:
        log.warning("no checkpoint found in %s — using random weights",
                    weights_dir)

    rng = random.Random(seed)
    picks = rng.sample(range(len(ds)), min(num_inference, len(ds)))
    outputs = []
    for k, i in enumerate(picks):
        sample = ds[i]
        boxes, scores, labels, valid = (
            t.cpu().numpy()
            for t in predict_step(state, sample["image"][None])[:4])
        v = valid[0]
        path = os.path.join(output_dir, f"inference_result_{k:03d}.png")
        draw_detections(
            sample["image"],
            sample["boxes"][sample["valid"]],
            sample["labels"][sample["valid"]] + 1,
            boxes[0][v], labels[0][v], scores[0][v],
            class_names={ci + 1: n for ci, n in
                         eval_idx.class_index_to_name.items()},
            out_path=path)
        outputs.append(path)
        log.info("saved %s (%d detections)", path, int(v.sum()))
    return outputs


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    multi_inference()
