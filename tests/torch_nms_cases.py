"""The detector post-process's class-offset NMS candidates, built one way for
the CPU test of its plain route (``tests/test_torch_nms_chunks.py``) and
the card's test of kernel 1 (``tests/test_torch_kernels.py``).

Imports the port and nothing of the JAX package, so that it loads on a
machine without JAX.
"""

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.ops.nms import topk_stable


def offset_candidates(rng, b: int, r: int, n_class: int, case: str,
                      size: int):
    """What ``FasterRCNN.post_process`` hands its NMS: the best ``4 * 100``
    (box, class) candidates of ``r`` rois (at most ``r * n_class``), sorted
    by ``topk_stable``, rows under the score threshold (0.05) at -1; boxes
    decoded per class inside a ``size`` px image.  ``case``: scores on
    three values (ties); one box a roi under every class; 70% of the rows
    under the threshold; image 1 with no valid row; 3% of the rows valid;
    every box of a class in one crowded spot.  Returns ``(cand_boxes [B, N, 4] f32, cand_scores [B, N] f32,
    cand_labels [B, N] int32, 1-based)``, the boxes not yet offset."""
    xy = rng.rand(b, r, n_class, 2) * (size * 7 / 8)
    wh = rng.rand(b, r, n_class, 2) * (size * 3 / 8) + 2
    fg = rng.rand(b, r, n_class) * 0.5
    if case == "tied_scores":
        fg = rng.randint(1, 4, size=fg.shape) / 8.0
    elif case == "same_box_two_classes":
        xy[:] = xy[:, :, :1]                   # one box a roi, every class
        wh[:] = wh[:, :, :1]
    elif case == "under_thresh":
        fg = np.where(rng.rand(*fg.shape) < 0.7, 0.01, fg)
    elif case == "no_valid_image":
        fg[1] = 0.02
    elif case == "few_survivors":
        fg = np.where(rng.rand(*fg.shape) < 0.97, 0.0, fg + 0.06)
    elif case == "suppress_most":
        # one crowded spot: every two boxes of a class overlap by IoU > 0.5
        xy = size * 5 / 16 + rng.rand(b, r, n_class, 2) * (size / 32)
        wh = size * 5 / 16 + rng.rand(b, r, n_class, 2) * (size / 32)
    else:
        raise ValueError(case)
    boxes = np.concatenate([xy, np.minimum(xy + wh, size)], -1)
    fg = torch.from_numpy(fg.astype(np.float32)).reshape(b, -1)
    flat = torch.where(fg >= 0.05, fg, -1.0)
    n_cand = min(400, flat.shape[1])
    cand_scores, cand = topk_stable(flat, n_cand)
    cand_boxes = torch.gather(
        torch.from_numpy(boxes.astype(np.float32)).reshape(b, -1, 4), 1,
        cand[..., None].expand(b, n_cand, 4))
    cand_labels = (cand % n_class + 1).to(torch.int32)
    return cand_boxes, cand_scores, cand_labels
