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
``labels [B, G]``, ``valid [B, G]`` of numpy arrays or tensors; with
``device_augment`` it first runs the augmentation chain of
:mod:`~..data.device_transforms` on the device.

The JAX package runs an accumulation cycle as one compiled ``lax.scan``
(``train_macro_step``, and ``train_macro_step_resident`` over a dataset
held on the device, :class:`~..data.device_cache.DeviceDatasetCache`) and
a whole eval pass over such a dataset as another (``eval_scan_resident``).
In eager PyTorch each is a Python loop of the same steps on the current
stream, under the same names and with the same results; nothing in them
waits for the card, and :func:`eval_scan_resident` brings its outputs to
the host in one copy.  The evaluator runs :func:`eval_scan_resident`;
``train()`` runs no macro step: its one epoch loop takes a ``train_step``
a batch from any loader, the cache included, which launches what a macro
step launches, so ``train_macro_step*`` are the JAX surface, for callers
that hold K batches or a cycle's indices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.device_transforms import (
    augment_batch)
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
    parameters' ``.grad``.  ``group``: the process group of a mesh's data
    axis (``parallel.mesh.place_train_state``), over whose ranks each
    update takes the mean gradient; None in one process.  ``model_group``:
    that of its model axis, over which the tensor-parallel heads gather
    (None without one).
    """

    cfg: Config
    model: FasterRCNN
    optimizer: torch.optim.Optimizer
    lr_of_update: Callable[[int], float]
    step: int = 0
    updates: int = 0
    group: object = None
    model_group: object = None


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
    last micro-step of a cycle, one AdamW update on the mean gradient (over
    the ranks of ``state.group`` too, with one all-reduce).

    ``generator`` draws the samplers' priorities (None: first k in index
    order).  ``device_augment``: augment the batch on its device first
    (:func:`~..data.device_transforms.augment_batch`), after the u8 -> f32
    conversion, drawing from ``generator`` (None: the device's default
    generator) before the samplers do.  Returns ``(state, losses)``;
    ``state`` is the one passed in, updated in place, and ``losses`` holds
    the five detached scalars.
    """
    model, k = state.model, max(state.cfg.grad_accum_steps, 1)
    b = _to_device(batch, model.device)
    images, boxes = _images_f32(b["image"]), b["boxes"]
    if device_augment:
        images, boxes = augment_batch(images, boxes, generator)
    out = model.train_forward(images, boxes, b["labels"], b["valid"],
                              train=True, generator=generator)
    out["losses"]["total"].backward()
    state.step += 1
    if state.step % k == 0:
        if state.group is not None:
            _all_reduce_mean(model, k, state.group, state.model_group)
        elif k > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_of_update(state.updates)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1
    return state, {name: v.detach() for name, v in out["losses"].items()}


def _all_reduce_mean(model, k: int, group, model_group=None) -> None:
    """The accumulated gradients become their mean over the ``k``
    micro-steps of the cycle and the data axis (the ranks' losses are means
    over equal batches, so the mean of their gradients is the global
    batch's): one all-reduce of one flat float32 buffer over the data group
    ``group``, divided by its size.

    With a model axis (``model_group``), that is the split parameters'
    reduction; the replicated ones (backbone, neck, RPN, every bias) take
    one over the whole mesh instead, divided by its size: the ranks of a
    model group read the same batch and hold the same gradient there, so
    it is the same mean, and every rank ends with the same bits even where
    a CUDA backward is not bitwise deterministic across processes."""
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        split_parameters)
    split = set(split_parameters(model))
    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    _reduce_mean_([g for n, g in named if n not in split], k,
                  group if model_group is None else None)
    _reduce_mean_([g for n, g in named if n in split], k, group)


def _reduce_mean_(grads, k: int, group) -> None:
    """Each of ``grads`` becomes its sum over ``group``'s ranks divided by
    ``k`` times their number: one all-reduce of one flat buffer."""
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_reduce_, world_size)
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, "sum", group).div_(k * world_size(group))
    at = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[at:at + n].view(g.shape))
        at += n


def train_macro_step(state: TrainState, superbatch: Dict,
                     generators: Sequence[Optional[torch.Generator]],
                     device_augment: bool = False
                     ) -> Tuple[TrainState, torch.Tensor]:
    """K micro-steps over the leading axis of ``superbatch`` (leaves ``[K,
    B, ...]``), micro-step ``k`` drawing from ``generators[k]``.  Returns
    ``(state, totals [K])``, the total losses on the device."""
    totals = []
    for k, gen in enumerate(generators):
        state, losses = train_step(state, {n: v[k] for n, v in superbatch.items()},
                                   gen, device_augment)
        totals.append(losses["total"])
    return state, torch.stack(totals)


def train_macro_step_resident(state: TrainState, data: Dict[str, torch.Tensor],
                              idx, generators: Sequence[Optional[torch.Generator]],
                              device_augment: bool = False
                              ) -> Tuple[TrainState, torch.Tensor]:
    """K micro-steps on batches gathered from a dataset held on the device.

    ``data``: the cache's leaves ``[N, ...]``
    (:attr:`~..data.device_cache.DeviceDatasetCache.data`); ``idx``: ``[K,
    B]`` sample indices of one accumulation cycle (numpy or a tensor),
    copied to the device once; the cycle's micro-batches are one gather of
    every leaf.  Returns ``(state, totals [K])`` as :func:`train_macro_step`."""
    return train_macro_step(state, _gather(data, idx), generators,
                            device_augment)


def _gather(data: Dict[str, torch.Tensor], idx) -> Dict[str, torch.Tensor]:
    """``data``'s rows at ``idx`` (numpy or a tensor, any shape), gathered on
    their device: leaves ``[*idx.shape, ...]``."""
    dev = next(iter(data.values())).device
    idx = torch.as_tensor(idx, dtype=torch.int64).to(dev, non_blocking=True)
    return {k: v[idx] for k, v in data.items()}


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


_EVAL_KEYS = ("boxes_pred", "classes_score_pred", "classes_pred", "pred_valid")


@torch.no_grad()
def eval_scan_resident(state: TrainState, data: Dict[str, torch.Tensor], idx,
                       use_predict: bool = False) -> Dict[str, np.ndarray]:
    """The whole eval pass over a dataset held on the device.

    ``idx``: ``[n_batches, B]`` sample indices.  Each batch is gathered from
    ``data`` and runs the train graph in eval mode (:func:`eval_step`, the
    reference's protocol) or, with ``use_predict``, the true predict path
    (``loss_total`` 0).  The outputs stay on the device, stacked, and come
    to the host in one copy: numpy leaves ``[n_batches, B, ...]`` under the
    JAX package's keys, ``boxes_pred``, ``classes_score_pred``,
    ``classes_pred``, ``pred_valid``, ``loss_total`` ``[n_batches]`` and the
    gathered ``gt_boxes``, ``gt_labels``, ``gt_valid``.
    """
    model = state.model
    outs = {}
    for sel in torch.as_tensor(idx, dtype=torch.int64):
        b = _gather(data, sel)              # one batch at a time
        images = _images_f32(b["image"])
        if use_predict:
            pred = model.predict(images)
            loss = torch.zeros((), dtype=torch.float32, device=images.device)
        else:
            o = model.train_forward(images, b["boxes"], b["labels"],
                                    b["valid"], train=False)
            pred = [o[k] for k in _EVAL_KEYS]
            loss = o["losses"]["total"]
        row = dict(zip(_EVAL_KEYS, pred), loss_total=loss,
                   gt_boxes=b["boxes"], gt_labels=b["labels"],
                   gt_valid=b["valid"])
        for k, v in row.items():
            outs.setdefault(k, []).append(v)
    return _to_host({k: torch.stack(v) for k, v in outs.items()})


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of ``tensors`` to host numpy in one device-to-host copy:
    their bytes packed into one buffer on the device, then split."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8)
            for t in tensors.values()]
    host = torch.cat(flat).cpu().numpy()
    out, at = {}, 0
    for (k, t), f in zip(tensors.items(), flat):
        n = f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[k] = host[at:at + n].view(dtype).reshape(t.shape)
        at += n
    return out
