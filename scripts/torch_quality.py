#!/usr/bin/env python3
"""Training quality of the PyTorch port: does it train a detector?

The port's counterpart of the JAX package's ``scripts/overfit_check.py``,
``scripts/overfit_resident.py`` and ``scripts/ablate_real_fixture.py``,
with their recipes, through the port's entry points
(``create_train_state``, ``train_step``, ``train_macro_step_resident``,
``DetectionDataset`` / ``Loader``, ``DeviceDatasetCache``,
``eval.evaluator.evaluate``)::

    python3 scripts/torch_quality.py overfit [--steps 300] [--backbone hardnet39] \\
        [--roi-pool-mode pool] [--set roi_bwd=pallas] [--json PATH]
    python3 scripts/torch_quality.py overfit-resident [--cycles 60] [--json PATH]
    python3 scripts/torch_quality.py real [--steps 400] [--backbone resnet50]

* ``overfit``: 4 synthetic 320x320 images (``generate_synthetic_coco``,
  seed 3), batch 4, one ``train_step`` a step on the same batch, then
  true-inference mAP@0.5 (``evaluate(use_predict=True)``) on it; the bar
  is mAP@0.5 > 0.3.  A ``-fpn`` backbone suffix (``resnet50-fpn``) trains
  the FPN variant.
* ``overfit-resident``: the same images held on the device
  (``DeviceDatasetCache``), ``cycles`` cycles of K=8 micro-steps through
  ``train_macro_step_resident`` with the augmentation on the device; the
  same bar, scored on the eval transform through the host ``Loader``.
* ``real``: the three committed JPEGs of ``tests/data/real_coco`` at
  600x600, ResNet-50, batch 3, host augmentation, 400 steps, in three
  variants (``single``: RoIAlign head; ``fpn``; ``fpn_locnorm``:
  ``loc_normalize``); mAP@0.5 and @0.75 on the eval transform, and for the
  FPN variants the share of test-time proposals that the windowed
  RoIAlign's window covers (``ops/roi_pool.py:window_coverage``).

Each recipe is a dict of ``Config`` fields (:func:`overfit_recipe`,
:func:`resident_recipe`, :func:`real_recipe`), so the same dict builds
either package's ``Config``.  Runs are on the GPU (``--device cuda``, the
default; the port never falls back to the CPU).  ``--device cpu --tiny``
trains the same recipe at 64x64 with proposal and sample counts cut and
float32 compute, for the tests.  The total loss is printed every 25 steps
(``overfit``), 10 cycles (``overfit-resident``) or 50 steps (``real``) and
at the last, and the numbers go to ``--json`` (default
``chiprun_out/torch_quality_<command>.json``).  Exits nonzero when a run
misses its bar (mAP@0.5 > 0.3 for the overfit runs, the JAX scripts'
assert; >= 0.5 for ``real``), a loss is not finite or the last logged
total is not below the first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from two_stage_object_detection_tpu_torch.config import Config  # noqa: E402
from two_stage_object_detection_tpu_torch.data.coco import load_coco  # noqa: E402
from two_stage_object_detection_tpu_torch.data.device_cache import (  # noqa: E402
    DeviceDatasetCache)
from two_stage_object_detection_tpu_torch.data.pipeline import (  # noqa: E402
    DetectionDataset, Loader)
from two_stage_object_detection_tpu_torch.data.synthetic import (  # noqa: E402
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.eval.evaluator import evaluate  # noqa: E402
from two_stage_object_detection_tpu_torch.nets.trainer import (  # noqa: E402
    create_train_state, predict_step, train_macro_step_resident, train_step)

REAL_ANN = os.path.join(ROOT, "tests/data/real_coco/annotations",
                        "instances_train2017.json")
REAL_IMAGES = os.path.join(ROOT, "tests/data/real_coco/train2017")
K = 8                     # micro-steps a cycle of the resident recipe
MAP_BAR = 0.3             # overfit_check.py:84, overfit_resident.py:87
REAL_BAR = 0.5            # under the JAX package's 0.83 / 1.0 / 1.0 (TPU)

# The recipes cut for a CPU test: 64x64 images (a fifth of 320), the
# single-scale anchors and the proposals' least side a fifth too, so that
# they still fit the boxes; proposal and sample counts as the other CPU
# tests take them; a narrow FPN; float32 compute
TINY = dict(input_size=(64, 64), anchor_scales=(2.0, 4.0, 8.0),
            proposal_min_size=3.2, n_train_pre_nms=128, n_train_post_nms=32,
            n_test_pre_nms=64, n_test_post_nms=16, roi_n_sample=8,
            rpn_n_sample=32, fpn_channels=32, fpn_fc_dim=64,
            compute_dtype="float32")

# ------------------------------------------------------------- the recipes
def overfit_recipe(steps: int = 300, backbone: str = "hardnet39",
                   roi_pool_mode: str = "pool") -> Dict:
    """``overfit_check.py:36-43``: ``Config`` fields."""
    return dict(
        fpn=backbone.endswith("-fpn"),
        input_size=(320, 320), num_classes=3, batch_size=4, max_gt_boxes=8,
        n_train_pre_nms=2000, n_train_post_nms=256, n_test_pre_nms=1000,
        n_test_post_nms=128, roi_n_sample=64, grad_accum_steps=1, lr=1e-3,
        score_thresh=0.3, predict_nms_iou=0.3, max_detections=16,
        cosine_t_max=steps, backbone=backbone.removesuffix("-fpn"),
        roi_pool_mode=roi_pool_mode)


def resident_recipe(cycles: int = 60, backbone: str = "hardnet39s",
                    roi_pool_mode: str = "align") -> Dict:
    """``overfit_resident.py:41-49``."""
    return dict(
        input_size=(320, 320), num_classes=3, batch_size=4, max_gt_boxes=8,
        n_train_pre_nms=2000, n_train_post_nms=256, n_test_pre_nms=1000,
        n_test_post_nms=128, roi_n_sample=64, grad_accum_steps=1, lr=1e-3,
        score_thresh=0.3, predict_nms_iou=0.3, max_detections=16,
        cosine_t_max=cycles * K, backbone=backbone,
        roi_pool_mode=roi_pool_mode, device_augment=True,
        transfer_uint8=True, fused_accum=True)


REAL_VARIANTS = {"single": dict(roi_pool_mode="align"),
                 "fpn": dict(fpn=True),
                 "fpn_locnorm": dict(fpn=True, loc_normalize=True)}


def real_recipe(steps: int = 400, variant: str = "single",
                backbone: str = "resnet50") -> Dict:
    """``ablate_real_fixture.py:142-160``, one of :data:`REAL_VARIANTS`."""
    return dict(
        input_size=(600, 600), num_classes=4, batch_size=3, max_gt_boxes=8,
        n_train_pre_nms=3000, n_train_post_nms=256, n_test_pre_nms=1000,
        n_test_post_nms=128, roi_n_sample=64, grad_accum_steps=1, lr=1e-3,
        score_thresh=0.3, predict_nms_iou=0.3, max_detections=16,
        cosine_t_max=steps, backbone=backbone, augment=True,
        **REAL_VARIANTS[variant])


def recipes() -> Dict[str, Dict]:
    """Every recipe the quality runs take, by run name."""
    out = {"overfit hardnet39/pool": overfit_recipe(),
           "overfit hardnet39/pool roi_bwd=pallas": {
               **overfit_recipe(), "roi_bwd": "pallas"},
           "overfit hardnet39/pool pallas_roi": {
               **overfit_recipe(), "pallas_roi": True},
           "overfit resnet50-fpn": overfit_recipe(backbone="resnet50-fpn"),
           "overfit-resident hardnet39s/align": resident_recipe()}
    out.update({f"real {v}": real_recipe(variant=v) for v in REAL_VARIANTS})
    return out


def make_config(recipe: Dict, device: str = "cuda", tiny: bool = False,
                **sets) -> Config:
    """The port's ``Config`` of a recipe, on ``device``; ``tiny`` applies
    :data:`TINY`, then ``sets``, further fields (``roi_bwd``,
    ``pallas_roi``): the one way a run's ``Config`` is overridden."""
    return Config(**{**recipe, **(TINY if tiny else {}), **sets},
                  device=device)


# ------------------------------------------------------------- the runs
def _all_finite(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """On the device: are all of a step's losses finite (no sync)."""
    return torch.isfinite(torch.stack([v.float() for v in losses.values()])
                          ).all()


def _train(state, batch_of: Callable[[int], Dict], steps: int, every: int,
           log: Callable) -> Dict:
    """``steps`` calls of ``train_step``, step ``i`` on ``batch_of(i)``
    drawing its samples from a generator seeded ``i`` (the JAX scripts'
    ``PRNGKey(i)``); the losses logged every ``every`` steps and at the
    last.  Returns the logged losses, whether every loss of every step was
    finite, the seconds and the images a second."""
    dev = state.model.device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    logged: List[Dict] = []
    n_images = 0
    t0 = time.perf_counter()
    for i in range(steps):
        batch = batch_of(i)
        gen = torch.Generator(device=dev).manual_seed(i)
        state, losses = train_step(state, batch, gen)
        finite &= _all_finite(losses)
        n_images += int(batch["image"].shape[0])
        if i % every == 0 or i == steps - 1:
            ls = {k: float(v) for k, v in losses.items()}
            logged.append({"step": i, **ls})
            log(f"step {i:4d}  total={ls['total']:.4f}  "
                f"rpn_cls={ls['rpn_cls']:.4f} rpn_loc={ls['rpn_loc']:.4f} "
                f"roi_cls={ls['roi_cls']:.4f} roi_loc={ls['roi_loc']:.4f}")
    finite = bool(finite)               # waits for the device
    seconds = time.perf_counter() - t0
    return {"losses": logged, "all_finite": finite, "steps": steps,
            "train_seconds": seconds, "images_per_s": n_images / seconds}


def _summary(out: Dict) -> Dict:
    """First and last logged totals; whether the run fell and stayed
    finite."""
    first, last = out["losses"][0]["total"], out["losses"][-1]["total"]
    out.update(first_loss=first, final_loss=last,
               loss_fell=bool(last < first))
    return out


def synthetic_images(cfg: Config, root: str):
    """The overfit recipes' data: 4 synthetic images of ``cfg.input_size``
    with up to 4 boxes of 3 classes, seed 3; ``(ann, image_dir)``."""
    return generate_synthetic_coco(root, num_images=4, num_classes=3,
                                   image_size=tuple(cfg.input_size), seed=3)


def run_overfit(cfg: Config, steps: int, log: Callable = print,
                on_trained: Callable = lambda: None) -> Dict:
    """``overfit_check.py``'s run: ``steps`` steps on one batch of the 4
    synthetic images, then mAP@0.5 on it through the trainer graph and
    through true inference (the bar).  ``on_trained()`` is called between
    the training and the evaluation (each run takes one)."""
    with tempfile.TemporaryDirectory(prefix="overfit_") as tmp:
        ann, img_dir = synthetic_images(cfg, tmp)
        ds = DetectionDataset(load_coco(ann, img_dir), cfg.input_size,
                              cfg.max_gt_boxes, train=False)
        loader = Loader(ds, cfg.batch_size, shuffle=False, num_workers=2)
        try:
            batch = next(iter(loader))
        finally:
            loader.close()
    _, state = create_train_state(cfg, seed=0)
    dev = state.model.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    log(f"backbone={cfg.backbone}{'-fpn' if cfg.fpn else ''} "
        f"roi_pool_mode={cfg.roi_pool_mode} roi_bwd={cfg.roi_bwd} "
        f"pallas_roi={cfg.pallas_roi} device={dev}")
    out = _train(state, lambda i: batch, steps, 25, log)
    on_trained()
    log(f"trained {steps} steps in {out['train_seconds']:.1f} s "
        f"({out['images_per_s']:.1f} img/s)")
    boxes, scores, labels, valid = predict_step(state, batch["image"])
    out["detections"] = int(valid.sum())
    out["max_score"] = float(scores.max())
    _, out["map50_trainer_graph"], _ = evaluate(
        state, [batch], cfg, map_iou_threshold=0.5, use_predict=False)
    _, out["map50"], metrics = evaluate(state, [batch], cfg,
                                        map_iou_threshold=0.5,
                                        use_predict=True)
    log(f"predict: {out['detections']} detections, max score "
        f"{out['max_score']:.3f}; mAP@0.5 trainer graph "
        f"{out['map50_trainer_graph']:.3f}, true inference {out['map50']:.3f}")
    for c, m in metrics["class_metrics"].items():
        log(f"  class {c}: AP={m['AP']:.3f} TP={m['TP']} FP={m['FP']} "
            f"FN={m['FN']} n_gt={m['n_gt']}")
    out["state"] = state
    out["batch"] = batch
    return _summary(out)


def run_resident(cfg: Config, cycles: int, log: Callable = print,
                 on_trained: Callable = lambda: None) -> Dict:
    """``overfit_resident.py``'s run: the 4 synthetic images held on the
    device, ``cycles`` cycles of ``K`` micro-steps through
    ``train_macro_step_resident`` with ``device_augment``, the cache's
    shuffled epochs refilling the cycle's index buffer; then true-inference
    mAP@0.5 through the host ``Loader``'s eval transform."""
    with tempfile.TemporaryDirectory(prefix="overfit_resident_") as tmp:
        ann, img_dir = synthetic_images(cfg, tmp)
        index = load_coco(ann, img_dir)
        ds = DetectionDataset(index, cfg.input_size, cfg.max_gt_boxes,
                              train=True, decode_only=True, uint8_images=True)
        cache = DeviceDatasetCache(ds, cfg.batch_size, shuffle=True, seed=0,
                                   device=cfg.device)
        eval_ds = DetectionDataset(index, cfg.input_size, cfg.max_gt_boxes,
                                   train=False)
        loader = Loader(eval_ds, cfg.batch_size, shuffle=False, num_workers=2)
        try:
            eval_batches = list(loader)
        finally:
            loader.close()
    _, state = create_train_state(cfg, seed=0)
    dev = state.model.device
    log(f"backbone={cfg.backbone} roi_pool_mode={cfg.roi_pool_mode} "
        f"cycles={cycles} (K={K}) device={dev}; cache {cache.nbytes} bytes "
        f"on {cache.device}")
    finite = torch.ones((), dtype=torch.bool, device=dev)
    logged = []
    t0 = time.perf_counter()
    buf = cache.epoch_indices()
    for c in range(cycles):
        while len(buf) < K:
            buf = np.concatenate([buf, cache.epoch_indices()])
        sel, buf = buf[:K], buf[K:]
        gens = [torch.Generator(device=dev).manual_seed(c * K + j)
                for j in range(K)]
        state, totals = train_macro_step_resident(
            state, cache.data, sel, gens, device_augment=cfg.device_augment)
        finite &= torch.isfinite(totals).all()
        if c % 10 == 0 or c == cycles - 1:
            t = float(totals.mean())
            logged.append({"cycle": c, "total": t})
            log(f"cycle {c:3d}  total={t:.4f}")
    finite = bool(finite)
    seconds = time.perf_counter() - t0
    on_trained()
    n = cycles * K
    # what the port reports of the loop: the micro-steps its state counted
    # and the length of each cycle's totals, from the cache on its device
    out = {"losses": logged, "all_finite": finite, "steps": n,
           "train_seconds": seconds,
           "images_per_s": n * cfg.batch_size / seconds,
           "micro_steps": state.step, "cycle_totals": int(totals.numel()),
           "cache_device": str(cache.device),
           "cache_bytes": int(cache.nbytes)}
    log(f"trained {n} micro-steps in {seconds:.1f} s "
        f"({out['images_per_s']:.1f} img/s)")
    _, out["map50"], _ = evaluate(state, eval_batches, cfg,
                                  map_iou_threshold=0.5, use_predict=True)
    log(f"true-inference mAP@0.5 = {out['map50']:.4f}")
    out["state"] = state
    return _summary(out)


@torch.no_grad()
def window_coverage_count(model, batches) -> Dict:
    """How many valid test-time proposals of ``batches`` the FPN head's
    window covers (``ablate_real_fixture.py:window_coverage_fraction``):
    the same level assignment as the head, then ``window_coverage``."""
    from two_stage_object_detection_tpu_torch.nets.fpn import (
        fpn_level_assign, span_aware_levels)
    from two_stage_object_detection_tpu_torch.nets.trainer import _images_f32
    from two_stage_object_detection_tpu_torch.ops.roi_pool import (
        window_coverage)
    cfg, head = model.cfg, model.roi_head
    n_pool = head.n_pool_levels
    model.set_mode(False)
    n_valid = n_cov = 0
    for b in batches:
        images = _images_f32(torch.as_tensor(b["image"]).to(model.device))
        h, w = images.shape[1:3]
        feats = model.features(images)
        rpn_locs, rpn_scores = model.rpn_head(feats)
        rois, _, valid = model.proposals(rpn_locs, rpn_scores, (h, w))
        levels = fpn_level_assign(
            rois, cfg.fpn_min_level, cfg.fpn_min_level + n_pool - 1,
            cfg.fpn_canonical_level, cfg.fpn_canonical_size) - cfg.fpn_min_level
        sizes = [[feats[li].shape[2], feats[li].shape[3]]
                 for li in range(n_pool)]
        scales = tuple((feats[li].shape[2] / h, feats[li].shape[3] / w)
                       for li in range(n_pool))
        if cfg.fpn_span_aware:
            levels = span_aware_levels(rois, levels, scales,
                                       float(cfg.fpn_roi_window - 2))
        cov = window_coverage(rois, levels, sizes, scales,
                              window=cfg.fpn_roi_window)
        n_valid += int(valid.sum())
        n_cov += int((cov & valid).sum())
    return {"proposals": n_valid, "covered": n_cov,
            "uncovered_fraction": 1.0 - n_cov / max(n_valid, 1)}


def run_real(cfg: Config, steps: int, log: Callable = print,
             on_trained: Callable = lambda: None) -> Dict:
    """``ablate_real_fixture.py:run_variant``: ``steps`` steps over the
    host ``Loader``'s augmented epochs of the three JPEGs, then mAP@0.5 and
    @0.75 on the eval transform (and the FPN window's coverage)."""
    index = load_coco(REAL_ANN, REAL_IMAGES)
    train_ds = DetectionDataset(index, cfg.input_size, cfg.max_gt_boxes,
                                train=True)
    val_ds = DetectionDataset(index, cfg.input_size, cfg.max_gt_boxes,
                              train=False)
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, num_workers=2)
    # 4 workers where the JAX script has 2: the batches are the same at any
    # count, and with 2 the card waits on the host's decode and
    # augmentation (PIL where the native library cannot be built)
    loader = Loader(train_ds, cfg.batch_size, shuffle=True, num_workers=4)
    try:
        val_batches = list(val_loader)
        epoch = iter(())

        def batch_of(i):
            nonlocal epoch
            b = next(epoch, None)
            if b is None:               # the loader's next epoch
                epoch = iter(loader)
                b = next(epoch)
            return b

        _, state = create_train_state(cfg, seed=0)
        log(f"backbone={cfg.backbone}{'-fpn' if cfg.fpn else ''} "
            f"roi_pool_mode={cfg.roi_pool_mode} loc_normalize="
            f"{cfg.loc_normalize} device={state.model.device}")
        out = _summary(_train(state, batch_of, steps, 50, log))
    finally:
        loader.close()
        val_loader.close()
    on_trained()
    for thr in (0.5, 0.75):
        _, m, _ = evaluate(state, val_batches, cfg, map_iou_threshold=thr,
                           use_predict=True)
        out[f"map{int(thr * 100)}"] = m
    if cfg.fpn and cfg.fpn_roi_window:
        out["window_coverage"] = window_coverage_count(state.model,
                                                       val_batches)
        log(f"  window coverage: {out['window_coverage']}")
    log(f"  mAP@0.5={out['map50']:.4f}  mAP@0.75={out['map75']:.4f}  "
        f"loss={out['final_loss']:.4f}  ({out['train_seconds']:.1f} s, "
        f"{out['images_per_s']:.1f} img/s)")
    out["state"] = state
    return out


# ------------------------------------------------------------- the gates
def failures(name: str, out: Dict, bar: float, strict: bool = True
             ) -> List[str]:
    """What a run got wrong: its mAP@0.5 under the bar (``> bar``, or
    ``>= bar`` with ``strict=False``), a loss not finite, or a last logged
    total not below the first."""
    bad = []
    m = out["map50"]
    if not (m > bar if strict else m >= bar):
        bad.append(f"{name}: mAP@0.5 {m:.4f} misses the bar "
                   f"{'>' if strict else '>='} {bar}")
    if not out["all_finite"]:
        bad.append(f"{name}: a loss is not finite")
    if not out["loss_fell"]:
        bad.append(f"{name}: the last logged total {out['final_loss']:.4f} "
                   f"is not below the first {out['first_loss']:.4f}")
    return bad


def record(out: Dict) -> Dict:
    """A run's numbers for JSON: the state and the batch left out."""
    return {k: v for k, v in out.items() if k not in ("state", "batch")}


# command -> (recipe builder, run, its default step or cycle count); the
# builder's first argument is that count
COMMANDS = {"overfit": (overfit_recipe, run_overfit, 300),
            "overfit-resident": (resident_recipe, run_resident, 60),
            "real": (real_recipe, run_real, 400)}


def run(command: str, n: Optional[int] = None, sets: Optional[Dict] = None,
        device: str = "cuda", tiny: bool = False, log: Callable = print,
        on_trained: Callable = lambda: None, **recipe_kw) -> Dict:
    """One run of ``command``: its recipe (``recipe_kw``: the builder's
    other arguments) at ``n`` steps or cycles, the ``Config`` through
    :func:`make_config` with ``sets``, trained and scored.  Returns the
    run's numbers with its recipe, bar (mAP@0.5 > 0.3 for the overfit
    runs, >= 0.5 for ``real``) and ``failures``."""
    build, train, default = COMMANDS[command]
    n = n or default
    recipe = build(n, **recipe_kw)
    cfg = make_config(recipe, device, tiny, **(sets or {}))
    out = train(cfg, n, log, on_trained)
    strict = command != "real"
    bar = MAP_BAR if strict else REAL_BAR
    name = " ".join([command] + [str(v) for v in recipe_kw.values()]
                    + [f"{k}={v}" for k, v in (sets or {}).items()])
    out.update(recipe=recipe, sets=sets or {},
               compute_dtype=cfg.compute_dtype, bar=bar,
               failures=failures(name, out, bar, strict))
    return out


def _json_path(path: Optional[str], command: str) -> str:
    path = os.path.abspath(path or os.path.join(
        ROOT, "chiprun_out", f"torch_quality_{command}.json"))
    if os.path.dirname(path) == ROOT and os.path.exists(path):
        raise SystemExit(f"--json {path}: an existing file at the "
                         f"repository's root (its result files live there)")
    return path


def _parse_sets(pairs) -> Dict:
    from two_stage_object_detection_tpu_torch.__main__ import _parse_override
    return dict(_parse_override(Config(), kv) for kv in pairs or [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name in ("overfit", "overfit-resident", "real"):
        p = sub.add_parser(name)
        p.add_argument("--device", default="cuda")
        p.add_argument("--tiny", action="store_true",
                       help="64x64, small proposal and sample counts, "
                            "float32: the recipe cut for a CPU test")
        p.add_argument("--set", action="extend", nargs="+",
                       metavar="KEY=VALUE",
                       help="override Config fields, as the CLI's --set")
        p.add_argument("--json", default=None)
    p = sub.choices["overfit"]
    p.add_argument("--steps", dest="n", type=int, help="default 300")
    p.add_argument("--backbone", default="hardnet39")
    p.add_argument("--roi-pool-mode", default="pool")
    p = sub.choices["overfit-resident"]
    p.add_argument("--cycles", dest="n", type=int, help="default 60")
    p.add_argument("--backbone", default="hardnet39s")
    p.add_argument("--roi-pool-mode", default="align")
    p = sub.choices["real"]
    p.add_argument("--steps", dest="n", type=int, help="default 400")
    p.add_argument("--backbone", default="resnet50")
    args = ap.parse_args(argv)
    sets = _parse_sets(args.set)
    path = _json_path(args.json, args.command)
    kw = dict(n=args.n, sets=sets, device=args.device, tiny=args.tiny)
    runs = {}
    if args.command == "real":
        for v in REAL_VARIANTS:
            print(f"=== {v} ===", flush=True)
            runs[f"real {v}"] = run("real", variant=v,
                                    backbone=args.backbone, **kw)
    else:
        runs[f"{args.command} {args.backbone}"] = run(
            args.command, backbone=args.backbone,
            roi_pool_mode=args.roi_pool_mode, **kw)
    result = {"command": args.command, "device": args.device,
              "tiny": args.tiny, "sets": sets,
              "runs": {name: record(out) for name, out in runs.items()}}
    if torch.cuda.is_available() and args.device.startswith("cuda"):
        result["card"] = torch.cuda.get_device_name(0)
    bad = [f for out in runs.values() for f in out["failures"]]
    result["failures"] = bad
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(f"wrote {path}")
    for line in bad:
        print(f"FAIL {line}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
