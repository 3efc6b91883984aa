"""PyTorch/CUDA port of the two-stage (Faster R-CNN) detector.

A second package beside the JAX one (``two_stage_object_detection_tpu``),
with the same module layout, the same ``Config`` and the same public
tensor layouts, for one NVIDIA Hopper GPU.  Plain tensor code is PyTorch;
each Pallas TPU kernel on the ported path is a hand-written CUDA kernel
(``csrc/``) with a plain PyTorch version beside it.  This package never
imports JAX or the JAX package.

Ported so far, for the FPN-ResNet flagship and the single-scale HarDNet
detector of the default ``Config()``: ``predict`` (``nets/detector.py``)
behind a ``Predictor`` (``serving.py``), and the train step
(``train_forward``, targets, losses, and the trainer of ``nets/trainer.py``:
AdamW, cosine schedule, gradient accumulation).  See ROADMAP.md for the
rest.
"""

__version__ = "0.1.0"

from two_stage_object_detection_tpu_torch.config import Config, load_config  # noqa: F401
