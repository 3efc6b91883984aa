"""Training state, optimiser, and the train / eval / predict steps.

The counterpart of the JAX package's ``nets/trainer.py``:

* AdamW over every parameter (batch-norm scales and biases included, as
  ``optax.adamw`` without a mask decays them), ``eps=1e-8``;
* the periodic cosine schedule ``lr * 0.5 * (1 + cos(pi * t / t_max))``
  counted in optimiser **updates** ``t`` (the first update runs at the full
  ``lr``; past ``t_max`` the rate climbs back up);
* gradient accumulation as ``optax.MultiSteps``: the mean of
  ``grad_accum_steps`` micro-gradients, then one update and one schedule
  step; batch-norm running statistics move at every micro-step.

A :class:`TrainState` holds the model, the optimiser and the counters; the
accumulator is the parameters' ``.grad``.  :func:`train_step` takes one
micro-step, in place, on a batch dict ``image [B, H, W, 3]`` (float in
[0, 1], or uint8, converted on the device), ``boxes [B, G, 4]``,
``labels [B, G]``, ``valid [B, G]`` of numpy arrays or tensors.

Not ported: ``train_macro_step*`` and ``eval_scan_resident`` (they read the
device-resident dataset cache) and ``device_augment=True`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.ops.geometry import div_exact


def make_optimizer(cfg: Config, params, steps_per_epoch: int = 1
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """AdamW and its schedule: ``(optimizer, lr_of_update)``.

    ``lr_of_update(t)`` is the learning rate of optimiser update ``t``
    (0-based): the caller sets it before each ``optimizer.step()``
    (:func:`train_step` does).
    """
    t_max_updates = max(cfg.cosine_t_max * steps_per_epoch
                        // max(cfg.grad_accum_steps, 1), 1)

    def lr_of_update(t: int) -> float:
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t / t_max_updates))

    opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return opt, lr_of_update


@dataclasses.dataclass
class TrainState:
    """The model in training, its optimiser and the counters.

    ``step`` counts micro-steps, ``updates`` optimiser updates; the
    micro-gradients of the running accumulation cycle are summed in the
    parameters' ``.grad``.
    """

    cfg: Config
    model: FasterRCNN
    optimizer: torch.optim.Optimizer
    lr_of_update: Callable[[int], float]
    step: int = 0
    updates: int = 0


def create_train_state(cfg: Config, seed: int = 0, steps_per_epoch: int = 1,
                       init_image_size: Optional[Tuple[int, int]] = None,
                       device=None) -> Tuple[FasterRCNN, TrainState]:
    """Build the model (seeded weights) and an initialised state.

    ``init_image_size`` is accepted for the JAX signature's sake: no
    parameter shape of the port depends on the image size.  ``device=None``
    takes ``cfg.device``.
    """
    del init_image_size
    model = FasterRCNN(cfg, device=device, seed=seed)
    opt, lr_of_update = make_optimizer(cfg, model.parameters(),
                                       steps_per_epoch)
    return model, TrainState(cfg, model, opt, lr_of_update)


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
            v, np.ndarray) else v
        out[k] = t.to(device, non_blocking=True)
    return out


def _images_f32(images: torch.Tensor) -> torch.Tensor:
    """u8 wire -> f32 in [0, 1] on the device (4x fewer bytes host to
    device); float images pass."""
    if images.dtype == torch.uint8:
        return div_exact(images.to(torch.float32), 255.0)
    return images


def train_step(state: TrainState, batch: Dict,
               generator: Optional[torch.Generator] = None,
               device_augment: bool = False
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro-step: forward, backward into the accumulator and, on the
    last micro-step of a cycle, one AdamW update on the mean gradient.

    ``generator`` draws the samplers' priorities (None: first k in index
    order).  Returns ``(state, losses)``; ``state`` is the one passed in,
    updated in place, and ``losses`` holds the five detached scalars.
    """
    if device_augment:
        raise NotImplementedError(
            "device_augment=True needs data/device_transforms.py, which is "
            "not ported yet (ROADMAP.md, 'Modules to port')")
    model, k = state.model, max(state.cfg.grad_accum_steps, 1)
    b = _to_device(batch, model.device)
    out = model.train_forward(_images_f32(b["image"]), b["boxes"], b["labels"],
                              b["valid"], train=True, generator=generator)
    out["losses"]["total"].backward()
    state.step += 1
    if state.step % k == 0:
        if k > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_of_update(state.updates)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1
    return state, {name: v.detach() for name, v in out["losses"].items()}


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict,
              generator: Optional[torch.Generator] = None,
              deterministic: bool = True):
    """Losses and trainer-parity predictions through the train graph in
    eval mode (running statistics, 3000/300 proposals); nothing is updated."""
    model = state.model
    b = _to_device(batch, model.device)
    return model.train_forward(
        _images_f32(b["image"]), b["boxes"], b["labels"], b["valid"],
        train=False, generator=None if deterministic else generator)


def predict_step(state: TrainState, images):
    """True inference ``-> (boxes, scores, labels, valid)`` on f32 or u8
    images (numpy or tensor)."""
    model = state.model
    x = _to_device({"image": images}, model.device)["image"]
    return model.predict(_images_f32(x))
