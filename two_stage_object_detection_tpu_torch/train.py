"""Training driver.

The port's copy of the JAX package's ``train.py``, with its surface:
epoch loop with tqdm, gradient accumulation, a periodic eval sweep over IoU
thresholds 0.5:0.05:0.95 -> mAP@{.5,.95,.5:.95}, best/last checkpoints,
preemption and exact resume, and the EMA-smoothed loss plots.  Batches come
from the host pipeline (:mod:`.data.pipeline`) and are copied to the card
from pinned memory (:class:`~.data.pipeline.DevicePut`); or, with
``cache_device``, from the dataset held on the card
(:mod:`.data.device_cache`), which takes the host out of the loop.  With
``device_augment`` the host only decodes and the augmentation runs on the
card (:mod:`.data.device_transforms`).

Several devices: one process each (``torchrun``, or
:func:`~.parallel.multiprocess.init_distributed`), over a
:class:`~.parallel.mesh.Mesh`: each data index trains on its shard of
every epoch, its batch norms take the global batch's statistics, and each
update all-reduces the gradient; a mesh with a model axis
(``make_mesh(n_data, n_model)``) also splits the dense heads over the ranks
of each model group (``parallel/sharding.py``), or with ``spatial`` carries
image rows: the ranks of a model group read the same batch and each runs
the backbone and neck on its rows (``parallel/spatial.py``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import (
    Config, load_config, resolve_device)
from two_stage_object_detection_tpu_torch.data.coco import load_coco
from two_stage_object_detection_tpu_torch.data.device_cache import (
    DeviceDatasetCache)
from two_stage_object_detection_tpu_torch.data.pipeline import (
    DetectionDataset, DevicePut, Loader)
from two_stage_object_detection_tpu_torch.eval.evaluator import evaluate_sweep
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_step)
from two_stage_object_detection_tpu_torch.parallel.mesh import (
    Mesh, auto_mesh, auto_mesh_spatial, make_mesh, model_axis_local,
    place_train_state, spatial_axes)
from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
    all_reduce_, init_distributed, rank, world_size)
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
from two_stage_object_detection_tpu_torch.utils.preemption import (
    PreemptionGuard)
from two_stage_object_detection_tpu_torch.utils.utils import (
    set_seed, update_ema)

log = logging.getLogger(__name__)


def step_generator(seed: int, epoch: int, step: int, device,
                   rank: int = 0) -> torch.Generator:
    """The sampling generator of micro-step ``step`` of ``epoch``: a fixed
    function of ``(seed, epoch, step)``, as the JAX package's
    ``fold_in(fold_in(rng, epoch), step)``, so that a resumed run draws what
    an uninterrupted one draws; rank ``r > 0`` of a data mesh folds ``r`` in
    as well, so the ranks draw apart and each resumes exactly.  ``train()``
    passes the data index (the rank in the data group), so the ranks of a
    model group, which read the same batch, draw alike: the same samples
    and, with image rows over the model axis, the same augmentation."""
    key = (seed, epoch, step) + ((rank,) if rank else ())
    s = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def build_loaders(cfg: Config, data_root: str = "data",
                  mesh: Optional[Mesh] = None):
    """COCO loaders following the reference's path layout
    (``dataset/data_organise.py:13-15``:
    ``data/annotations/instances_{split}2017.json``), each placing its
    batches on ``cfg.device`` (:class:`DevicePut`), or on the rank's device
    of ``mesh``.  Returns ``(train_loader, eval_loader, eval_index)``.

    Over a mesh of several processes each rank's train loader yields its
    data index's shard of every epoch (``shard_count`` / ``shard_index``:
    the same seeded order everywhere, a strided slice each, equal
    lengths).  The
    eval loader is not sharded: every rank iterates the full eval set, so
    the metrics and the ``_best`` decision keyed on them are the same on
    every rank (the evaluator splits each batch's rows over the ranks and
    gathers the predictions).

    ``cfg.device_augment``: both datasets decode and resize only
    (``decode_only``); the train step augments on the device.
    ``cfg.cache_device`` (needs ``device_augment``): both sets are held on
    the device (:class:`~.data.device_cache.DeviceDatasetCache`); if they
    exceed ``cache_device_max_bytes``, a warning and the streaming loaders,
    as in the JAX package.  Under a mesh every rank holds both sets on its
    own card (replicated, as the JAX package holds the cache under
    ``spatial``), and the ranks of a model group, which share a data index,
    gather the same batches.
    """
    if cfg.cache_device and not cfg.device_augment:
        raise ValueError("cache_device=True requires device_augment=True "
                         "(the cache is epoch-invariant; augmentation must "
                         "run on device)")
    dev = resolve_device(cfg.device) if mesh is None else mesh.device
    shards = ({} if mesh is None else
              dict(shard_count=mesh.processes, shard_index=mesh.data_index))
    train_idx = load_coco(
        os.path.join(data_root, "annotations", "instances_train2017.json"),
        os.path.join(data_root, "train2017"), ratio=cfg.train_ratio,
        polygons=cfg.mask_head)
    eval_idx = load_coco(
        os.path.join(data_root, "annotations", "instances_val2017.json"),
        os.path.join(data_root, "val2017"), ratio=cfg.eval_ratio,
        polygons=cfg.mask_head)
    train_ds = DetectionDataset(train_idx, cfg.input_size, cfg.max_gt_boxes,
                                train=cfg.augment,
                                decode_only=cfg.device_augment,
                                cache=cfg.cache_decoded,
                                cache_max_bytes=cfg.cache_max_bytes,
                                uint8_images=cfg.transfer_uint8,
                                max_vertices=(cfg.max_mask_vertices if cfg.mask_head
                                              else 0))
    eval_ds = DetectionDataset(eval_idx, cfg.input_size, cfg.max_gt_boxes,
                               train=False, decode_only=cfg.device_augment,
                               cache=cfg.cache_decoded,
                               cache_max_bytes=cfg.cache_max_bytes,
                               uint8_images=cfg.transfer_uint8,
                               max_vertices=(cfg.max_mask_vertices if cfg.mask_head
                                             else 0))
    if cfg.cache_device:
        mk_cached = lambda ds, shuffle, **kw: DeviceDatasetCache(
            ds, cfg.batch_size, shuffle=shuffle, seed=0,
            max_bytes=cfg.cache_device_max_bytes,
            num_workers=cfg.num_workers, device=dev, **kw)
        try:
            return (mk_cached(train_ds, True, **shards),
                    mk_cached(eval_ds, False), eval_idx)
        except MemoryError as e:
            log.warning("cache_device: %s — falling back to streaming Loader",
                        e)
    put = DevicePut(dev)
    mk = lambda ds, shuffle, **kw: Loader(
        ds, cfg.batch_size, shuffle=shuffle, num_workers=cfg.num_workers,
        prefetch=cfg.prefetch_factor, device_put=put,
        worker_mode=cfg.worker_mode,
        persistent_workers=cfg.persistent_workers, **kw)
    return mk(train_ds, True, **shards), mk(eval_ds, False), eval_idx


def train(visualization: bool = True, cfg: Optional[Config] = None,
          data_root: str = "data", weights_dir: str = "weights",
          pre_train: bool = False, resume: bool = False,
          eval_period: int = 10, seed: int = 42, mesh="auto",
          spatial: bool = False, guard: Optional[PreemptionGuard] = None):
    """Run the full training loop (reference ``train()`` signature kept).

    ``mesh``: ``"auto"`` brings up ``torch.distributed`` from ``torchrun``'s
    environment (:func:`~.parallel.multiprocess.init_distributed`; nothing
    in one process) and, over several ranks, builds the data mesh
    (:func:`~.parallel.mesh.auto_mesh`, one rank a device, each on
    ``cuda:LOCAL_RANK``, or ``cfg.device`` where that names an index).
    ``None`` trains on ``cfg.device`` alone; an explicit
    :class:`~.parallel.mesh.Mesh` must be over processes.  On a mesh each
    data index trains on its shard of every epoch (``cfg.batch_size`` is a
    data index's batch), its batch norms take the global batch's
    statistics, each update all-reduces the gradient, and the ranks end
    bitwise equal; on a mesh with a model axis
    (``make_mesh(n_data, n_model)``) the ranks of a model group read the
    same batch and split the dense heads, and the checkpoints hold the
    full layout.  The eval splits each batch over the data axis only.

    ``spatial``: shard image height over the mesh's model axis as well
    (small batches of large images: a batch smaller than the rank count
    still uses every rank).  With ``mesh="auto"`` the mesh is then
    :func:`~.parallel.mesh.auto_mesh_spatial`'s; the parameters are
    replicated, the ranks of a model group read the same batch (its
    augmentation drawn for the data index, before the rows are split) and
    exchange halos (``parallel/spatial.py``), and every batch norm takes
    the whole mesh.  A model axis that would cross nodes (torchrun's
    ``LOCAL_WORLD_SIZE`` not a multiple of it) falls back to data
    parallelism with a warning, as the JAX package falls back over several
    processes.  On a mesh with no model axis it changes nothing.

    ``resume``: restore the full train state (parameters, batch-norm
    statistics, optimiser moments, counters) from the ``_last`` checkpoint
    and continue inside the epoch that was interrupted: the epoch's
    deterministic batch order is replayed, the batches already applied are
    skipped, the loader's epoch clock is restored, and every micro-step
    draws its sampling from :func:`step_generator`, so the resumed run
    equals an uninterrupted one.  ``pre_train`` restores the ``_best``
    parameters and statistics only, with a fresh optimiser
    (``train/train.py:60-72``).  On a mesh rank 0 writes the checkpoints
    and every rank restores.

    ``guard``: a :class:`~.utils.preemption.PreemptionGuard` (one is created
    if omitted).  SIGTERM, or ``guard.request()``, stops the loop at the
    next step boundary, saves ``_last`` and returns; over several ranks the
    stop is agreed (``should_stop`` syncs), so every rank stops at the same
    step.

    One epoch loop serves every loader: each micro-step ``s`` of an epoch
    is one ``train_step`` on the loader's next batch, drawing from
    ``step_generator(seed, epoch, s)``; with ``cache_device`` the loader is
    a :class:`~.data.device_cache.DeviceDatasetCache`, whose batches are
    gathered on the device, so the same loop runs without the host
    pipeline (the resident loop).  The augmentation runs on the device
    when ``cfg.device_augment and cfg.augment``.  ``cfg.fused_accum``
    changes nothing here: the JAX package's macro step fuses a cycle's
    micro-steps into one compiled program, and in eager PyTorch it is the
    same micro-steps in a loop (``nets.trainer.train_macro_step*``).

    Each epoch logs its loop time (input, copies and micro-steps, ending in
    a synchronisation; the eval after it excluded) and its mean loss, with
    the numbers as record attributes ``epoch``, ``micro_steps``, ``images``,
    ``seconds``, ``loss`` and ``loop`` (``"resident"`` over a
    ``DeviceDatasetCache``, else ``"stream"``).  The losses come to the
    host once an epoch (on a mesh, averaged over the ranks: the global
    batch's; ``images`` counts every rank's).
    """
    cfg = cfg or load_config()
    if mesh == "auto":
        init_distributed(device=cfg.device)
        n = world_size()
        spatial = spatial and n > 1 and model_axis_local(
            spatial_axes(cfg.batch_size, n)[1])
        mesh = (None if n <= 1 else
                auto_mesh_spatial(cfg.batch_size, devices=[cfg.device])
                if spatial else
                auto_mesh(cfg.batch_size, devices=[cfg.device]))
    elif mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be 'auto', None or a parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if mesh is not None and mesh.group is None:
        raise ValueError("train() runs one process a device: a mesh over "
                         "several devices of one process does not train; "
                         "launch one process per device (torchrun)")
    spatial = spatial and mesh is not None and mesh.shape["model"] > 1
    if spatial and not model_axis_local(mesh.shape["model"]):
        spatial, mesh = False, make_mesh(devices=[mesh.device])
    dev = resolve_device(cfg.device) if mesh is None else mesh.device
    set_seed(seed)

    train_loader, eval_loader, _ = build_loaders(cfg, data_root, mesh)
    try:
        return _run(visualization, cfg, dev, mesh, spatial, train_loader,
                    eval_loader, weights_dir, pre_train, resume, eval_period,
                    seed, guard or PreemptionGuard())
    finally:
        train_loader.close()
        eval_loader.close()


def _run(visualization, cfg, dev, mesh, spatial, train_loader, eval_loader,
         weights_dir, pre_train, resume, eval_period, seed, guard):
    steps_per_epoch = max(len(train_loader), 1)
    _, state = create_train_state(cfg, seed=seed,
                                  steps_per_epoch=steps_per_epoch, device=dev)
    if mesh is not None:
        place_train_state(state, mesh, spatial=spatial)
        log.info("training on %d ranks, mesh=%s, data index %d, model "
                 "index %d on %s%s", world_size(), mesh.shape,
                 mesh.data_index, mesh.model_index, dev,
                 " (spatial: image height over 'model')" if spatial else "")
    group = None if mesh is None else mesh.group
    lead = rank() == 0              # writes the sidecar; rank 0 checkpoints
    os.makedirs(weights_dir, exist_ok=True)

    start_epoch = 0
    skip_steps = 0   # applied micro-steps of the resumed (partial) epoch
    min_eval_loss = float("inf")   # global best (the reference resets this
    # every eval round, train/train.py:95,120 — quirk #9, fixed)
    meta_path = os.path.join(weights_dir, "train_meta.json")
    if resume:
        if ckpt.restore_checkpoint(weights_dir, state, name=ckpt.LAST) is not None:
            # TrainState.step counts micro-steps; continue inside the epoch
            # that was interrupted, skipping the batches already applied
            start_epoch = min(state.step // steps_per_epoch, cfg.num_epochs)
            if start_epoch < cfg.num_epochs:
                skip_steps = state.step % steps_per_epoch
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    min_eval_loss = float(
                        json.load(f).get("min_eval_loss", float("inf")))
            log.info("✅ Resumed full train state at step %d (epoch %d, "
                     "best eval loss %.4f)", state.step, start_epoch,
                     min_eval_loss)
    elif pre_train:
        if ckpt.restore_checkpoint(weights_dir, state, name=ckpt.BEST,
                                   params_only=True) is not None:
            log.info("✅ Successfully loaded pretrained model")

    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = lambda it, **kw: it

    train_loss, eval_loss = [], []
    mAP50_list, mAP50_95_list, mAP95_list = [], [], []

    def _eval_and_checkpoint():
        nonlocal min_eval_loss
        sweep = evaluate_sweep(state, lambda: eval_loader, cfg)
        mAP50_list.append(sweep["mAP50"])
        mAP95_list.append(sweep["mAP95"])
        mAP50_95_list.append(sweep["mAP50_95"])
        eval_loss.append(sweep["eval_loss"])
        if sweep["eval_loss"] < min_eval_loss:
            min_eval_loss = sweep["eval_loss"]
            ckpt.save_checkpoint(weights_dir, state, name=ckpt.BEST)
            log.info("✅ Best model saved to %s", weights_dir)
        log.info("eval: mAP_50%%: %.4f, mAP_50%%_95%%: %.4f, mAP_95%%: %.4f",
                 sweep["mAP50"], sweep["mAP50_95"], sweep["mAP95"])
        # periodic full-state save so ``resume=True`` can recover a crashed
        # or preempted run; the write overlaps the next epoch's steps
        ckpt.save_checkpoint(weights_dir, state, name=ckpt.LAST, wait=False)
        if lead:
            with open(meta_path, "w") as f:
                json.dump({"min_eval_loss": min_eval_loss}, f)

    preempted = False
    train_loader.epoch = start_epoch   # restore the shuffle-order clock
    aug = cfg.device_augment and cfg.augment
    loop_kind = ("resident" if isinstance(train_loader, DeviceDatasetCache)
                 else "stream")
    with guard:
        for epoch in range(start_epoch, cfg.num_epochs):
            # losses stay on the device during the epoch and come to the
            # host once at its end
            skip = skip_steps if epoch == start_epoch else 0
            gen_at = lambda s, epoch=epoch: step_generator(
                seed, epoch, s, dev, rank(group))
            t0 = time.perf_counter()
            pending, preempted = train_epoch(
                state, tqdm(train_loader, total=steps_per_epoch,
                            desc=f"Epoch {epoch + 1}/{cfg.num_epochs}",
                            colour="green", disable=not lead), skip, aug,
                gen_at, guard)
            losses = []
            if pending:
                stacked = torch.stack(pending)
                if group is not None:      # the global batch's: rank mean
                    all_reduce_(stacked, "sum", group).div_(world_size(group))
                losses = stacked.cpu().tolist()
            seconds = time.perf_counter() - t0
            train_loss.extend(losses)
            n_img = len(losses) * cfg.batch_size * world_size(group)
            mean = float(np.mean(losses)) if losses else float("nan")
            log.info("epoch %d: %d micro-steps (%d images) in %.3f s, %s "
                     "loop = %.1f img/s; mean loss %.4f",
                     epoch + 1, len(losses), n_img, seconds, loop_kind,
                     n_img / seconds, mean,
                     extra={"epoch": epoch + 1, "micro_steps": len(losses),
                            "images": n_img, "seconds": seconds,
                            "loss": mean, "loop": loop_kind})
            if preempted:
                break
            if epoch % eval_period == 0:
                _eval_and_checkpoint()

        ckpt.save_checkpoint(weights_dir, state, name=ckpt.LAST)
        if preempted:
            log.warning("⚠️ Preempted at step %d — full state saved to %s; "
                        "train(resume=True) continues this run",
                        state.step, weights_dir)
        else:
            log.info("✅ Last model saved to %s", weights_dir)

    if visualization and train_loss and lead:
        from two_stage_object_detection_tpu_torch.utils.draw import (
            plot_training_metrics)
        ema_alpha = 0.01
        ema_train = []
        for i, v in enumerate(train_loss):
            ema_train.append(v if i == 0 else update_ema(v, ema_alpha, ema_train[-1]))
        ema_eval = []
        for i, v in enumerate(eval_loss):
            ema_eval.append(v if i == 0 else update_ema(v, ema_alpha, ema_eval[-1]))
        plot_training_metrics(
            epoch_num=cfg.num_epochs, step_num=list(range(len(train_loss))),
            train_loss=train_loss, ema_train_loss=ema_train,
            eval_loss=eval_loss, ema_eval_loss=ema_eval,
            mAP50_list=mAP50_list, mAP50_95_list=mAP50_95_list,
            mAP95_list=mAP95_list)

    return state


def train_epoch(state, batches, skip, aug, gen_at, guard):
    """One epoch of micro-steps over ``batches``, skipping the first
    ``skip`` (applied before a preemption); micro-step ``i`` draws from
    ``gen_at(i)``.  Nothing in it waits for the device: the losses stay
    there.  Returns ``(pending losses, preempted)``."""
    pending = []
    for i, batch in enumerate(batches):
        if i < skip:
            continue
        if guard.should_stop():
            return pending, True
        _, losses = train_step(state, batch, gen_at(i), aug)
        pending.append(losses["total"])
    return pending, False


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train()
