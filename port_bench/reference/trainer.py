"""The reference's training step.

Frozen from the port's ``nets/trainer.py`` (``make_optimizer``,
``train_step`` on one process): AdamW (``eps=1e-8``, betas 0.9 / 0.999,
decoupled weight decay over every parameter), the periodic cosine
schedule counted in updates, and accumulation as the mean of
``grad_accum_steps`` micro-gradients before one update.  With
``device_augment`` the batch is augmented on its device first, drawing
from the micro-step's generator before the samplers do.
"""

from __future__ import annotations

import math

import torch

from .device_transforms import augment_batch
from .wire import u8_to_float


class Trainer:
    """The model, its optimiser and the counters of one training run."""

    def __init__(self, cfg, model, steps_per_epoch: int):
        self.cfg, self.model = cfg, model
        self.t_max = max(cfg.cosine_t_max * steps_per_epoch
                         // max(cfg.grad_accum_steps, 1), 1)
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.step = self.updates = 0
        self.first_grads = None
        self.rpn_losses = []

    def lr(self, t: int) -> float:
        return self.cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t / self.t_max))

    def micro_step(self, batch: dict, generator, device_augment: bool):
        """One micro-step on ``batch`` (``image`` u8, ``boxes``, ``labels``,
        ``valid``); returns the detached total loss.  The first update keeps the mean gradient it applies, on the host in
        float32, in :attr:`first_grads` (name -> tensor); each micro-step
        appends its RPN loss to :attr:`rpn_losses`."""
        model, k = self.model, max(self.cfg.grad_accum_steps, 1)
        images, boxes = u8_to_float(batch["image"]), batch["boxes"]
        if device_augment:
            images, boxes = augment_batch(images, boxes, generator)
        out = model.train_forward(images, boxes, batch["labels"],
                                  batch["valid"], train=True,
                                  generator=generator)
        out["losses"]["total"].backward()
        self.rpn_losses.append((out["losses"]["rpn_loc"]
                                + out["losses"]["rpn_cls"]).detach())
        self.step += 1
        if self.step % k == 0:
            for p in model.parameters():
                if p.grad is not None and k > 1:
                    p.grad.div_(k)
            if self.updates == 0:
                self.first_grads = {
                    n: p.grad.detach().float().cpu()
                    for n, p in model.named_parameters() if p.grad is not None}
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.updates)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
        return out["losses"]["total"].detach()
