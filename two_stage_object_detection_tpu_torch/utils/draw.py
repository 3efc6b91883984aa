"""Training-metric plots and detection visualisation (matplotlib Agg).

The port's copy of the JAX package's ``utils/draw.py``.  Equivalents of
reference ``utils/draw.py:9-181`` (3-panel loss/mAP figure) and the
GT-vs-prediction rendering in ``multi_inference.py:100-177``.  matplotlib
is imported inside the functions, so that ``train --no-viz`` and ``eval``
run where it is not installed.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_metrics(epoch_num: int, step_num: Sequence[int],
                          train_loss, ema_train_loss, eval_loss,
                          ema_eval_loss, mAP50_list, mAP50_95_list,
                          mAP95_list, out_path: str = "training_metrics.png"):
    """3-panel figure: train loss + EMA, eval loss + EMA, mAP curves
    (reference ``utils/draw.py:9-181``)."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(10, 12))

    ax = axes[0]
    ax.plot(step_num, train_loss, alpha=0.35, label="train loss")
    ax.plot(step_num, ema_train_loss, label="EMA train loss")
    if epoch_num > 0 and len(step_num) > 0:
        per_epoch = max(len(step_num) // max(epoch_num, 1), 1)
        for e in range(1, epoch_num):
            ax.axvline(e * per_epoch, color="grey", ls=":", lw=0.5)
    ax.set_title("Training loss")
    ax.set_xlabel("step")
    ax.legend()

    ax = axes[1]
    xs = list(range(len(eval_loss)))
    ax.plot(xs, eval_loss, alpha=0.35, label="eval loss")
    ax.plot(xs, ema_eval_loss, label="EMA eval loss")
    ax.set_title("Eval loss")
    ax.set_xlabel("eval round")
    ax.legend()

    ax = axes[2]
    xs = list(range(len(mAP50_list)))
    ax.plot(xs, mAP50_list, marker="o", label="mAP@0.5")
    ax.plot(xs, mAP50_95_list, marker="s", label="mAP@0.5:0.95")
    ax.plot(xs, mAP95_list, marker="^", label="mAP@0.95")
    ax.set_title("mAP")
    ax.set_xlabel("eval round")
    ax.set_ylim(0, 1)
    ax.legend()

    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path


def draw_detections(image: np.ndarray, boxes_gt, labels_gt, boxes_pred,
                    labels_pred, scores_pred, class_names: Optional[dict] = None,
                    out_path: str = "inference_result.png"):
    """Render GT (green) vs predictions (red) with class names + confidence
    (reference ``multi_inference.py:100-177``)."""
    plt = _pyplot()
    import matplotlib.patches as patches
    fig, ax = plt.subplots(1, 1, figsize=(12, 8))
    img = np.clip(np.asarray(image), 0, 1)
    ax.imshow(img)

    def name(lbl):
        if class_names and int(lbl) in class_names:
            return str(class_names[int(lbl)])
        return str(int(lbl))

    for box, lbl in zip(np.asarray(boxes_gt), np.asarray(labels_gt)):
        x1, y1, x2, y2 = box
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       edgecolor="lime", fill=False, lw=2))
        ax.text(x1, y1 - 3, f"GT {name(lbl)}", color="lime", fontsize=8)

    for box, lbl, sc in zip(np.asarray(boxes_pred), np.asarray(labels_pred),
                            np.asarray(scores_pred)):
        x1, y1, x2, y2 = box
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       edgecolor="red", fill=False, lw=1.5))
        ax.text(x1, y2 + 8, f"{name(lbl)} {float(sc):.2f}", color="red",
                fontsize=8)

    ax.set_axis_off()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return out_path
