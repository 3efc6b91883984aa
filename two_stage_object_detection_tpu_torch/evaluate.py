"""Standalone evaluation driver: score a checkpoint on the val set.

The port's copy of the JAX package's ``evaluate.py``.  It loads a saved
checkpoint and runs the full mAP@[.5:.95] sweep on the validation
annotations — through either the reference's trainer-graph protocol or the
true inference path — without touching the training loop (the reference
can only evaluate inside a training run, ``train/train.py:94-117``).  With
``cache_device`` the eval set is held on the device and the pass runs over
it (``data/device_cache.py``).  Under ``torchrun`` the ranks split each
eval batch's rows and gather the predictions, and every rank returns the
same scores; with ``spatial`` the ranks of a model group split each
image's rows as well.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from two_stage_object_detection_tpu_torch.config import Config, load_config
from two_stage_object_detection_tpu_torch.data.coco import load_coco
from two_stage_object_detection_tpu_torch.data.device_cache import (
    DeviceDatasetCache)
from two_stage_object_detection_tpu_torch.data.pipeline import (
    DetectionDataset, DevicePut, Loader)
from two_stage_object_detection_tpu_torch.eval.evaluator import evaluate_sweep
from two_stage_object_detection_tpu_torch.nets.trainer import create_train_state
from two_stage_object_detection_tpu_torch.parallel.mesh import (
    auto_mesh, auto_mesh_spatial, model_axis_local, place_train_state,
    spatial_axes)
from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
    init_distributed, world_size)
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt

log = logging.getLogger(__name__)


def build_eval_loader(cfg: Config, data_root: str = "data", device=None):
    """Validation loader (COCO layout, reference
    ``dataset/data_organise.py:13-15``) -> ``(loader, eval_index)``; its
    batches land on ``device`` (default ``cfg.device``).  With ``cfg.cache_device`` the set is
    held on the device (:class:`~.data.device_cache.DeviceDatasetCache`),
    unless it exceeds ``cache_device_max_bytes``: then a warning, and the
    streaming loader."""
    eval_idx = load_coco(
        os.path.join(data_root, "annotations", "instances_val2017.json"),
        os.path.join(data_root, "val2017"), ratio=cfg.eval_ratio,
        polygons=cfg.mask_head)
    # eval applies no augmentation: decode_only (which the device cache
    # requires) only moves the resize into the decoder
    ds = DetectionDataset(eval_idx, cfg.input_size, cfg.max_gt_boxes,
                          train=False, decode_only=cfg.cache_device,
                          cache=cfg.cache_decoded,
                          cache_max_bytes=cfg.cache_max_bytes,
                          uint8_images=cfg.transfer_uint8,
                          max_vertices=(cfg.max_mask_vertices if cfg.mask_head
                                        else 0))
    device = cfg.device if device is None else device
    if cfg.cache_device:
        try:
            return DeviceDatasetCache(
                ds, cfg.batch_size, shuffle=False,
                max_bytes=cfg.cache_device_max_bytes,
                num_workers=cfg.num_workers, device=device), eval_idx
        except MemoryError as e:
            log.warning("cache_device: %s — falling back to streaming "
                        "Loader", e)
    return Loader(ds, cfg.batch_size, shuffle=False,
                  num_workers=cfg.num_workers, prefetch=cfg.prefetch_factor,
                  device_put=DevicePut(device),
                  worker_mode=cfg.worker_mode,
                  persistent_workers=cfg.persistent_workers), eval_idx


def evaluate_checkpoint(weights_dir: str = "weights",
                        cfg: Optional[Config] = None,
                        data_root: str = "data", name: Optional[str] = None,
                        use_predict: bool = False,
                        coco_summary: bool = False, seed: int = 0,
                        spatial: bool = False) -> dict:
    """Score ``FasterRCNNTrainer_{best,last}`` weights on the val set.

    Returns the :func:`~.eval.evaluator.evaluate_sweep` dict —
    ``mAP50`` / ``mAP95`` / ``mAP50_95`` / ``eval_loss`` (plus ``coco``
    when ``coco_summary=True``).  Raises ``FileNotFoundError`` when the
    checkpoint is missing.

    ``use_predict=False`` scores through the trainer graph (the
    reference's eval protocol, ``nets/frcnn_training.py:347-370``);
    ``True`` scores the true inference path (score threshold + per-class
    NMS — what deployment actually serves).  The pass's time (loader, device
    and host metric work) is logged, and kept on the record as ``seconds``.

    Under ``torchrun`` (:func:`~.parallel.multiprocess.init_distributed`
    reads its environment) each rank runs on its device of the data mesh
    and scores the same predictions.  ``spatial``: the mesh of
    :func:`~.parallel.mesh.auto_mesh_spatial`, each data index's images
    split by rows over its model group, as ``train(spatial=True)``
    evaluates.
    """
    cfg = cfg or load_config()
    init_distributed(device=cfg.device)
    mesh = None
    if world_size() > 1:
        # train(spatial=True)'s guard: a model axis crossing nodes falls
        # back to data parallelism
        spatial = spatial and model_axis_local(
            spatial_axes(cfg.batch_size, world_size())[1])
        mesh = (auto_mesh_spatial if spatial else auto_mesh)(
            cfg.batch_size, devices=[cfg.device])
    _, state = create_train_state(
        cfg, seed=seed, device=None if mesh is None else mesh.device)
    if ckpt.restore_checkpoint(weights_dir, state, name=name or ckpt.BEST,
                               params_only=True) is None:
        raise FileNotFoundError(
            f"no checkpoint {name or ckpt.BEST!r} under {weights_dir!r}")
    if mesh is not None:
        place_train_state(state, mesh, spatial=spatial)
    loader, _ = build_eval_loader(cfg, data_root, state.model.device)
    try:
        t0 = time.perf_counter()
        sweep = evaluate_sweep(state, lambda: loader, cfg,
                               use_predict=use_predict,
                               coco_summary=coco_summary)
        seconds = time.perf_counter() - t0
    finally:
        loader.close()
    protocol = "predict" if use_predict else "train-graph"
    log.info("eval[%s]: mAP@0.5 %.4f  mAP@[.5:.95] %.4f  mAP@0.95 %.4f  "
             "loss %.4f  (%.3f s)", protocol, sweep["mAP50"],
             sweep["mAP50_95"], sweep["mAP95"], sweep["eval_loss"], seconds,
             extra={"protocol": protocol, "seconds": seconds})
    return sweep


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    evaluate_checkpoint()
