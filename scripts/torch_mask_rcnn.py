#!/usr/bin/env python3
"""Mask R-CNN on the card: kernel 2 at the mask head's P=14, and training
micro-steps of ``port_bench/configs/mask_r50.json``.

    python3 scripts/torch_mask_rcnn.py align [--json PATH]
    python3 scripts/torch_mask_rcnn.py train [--batch 16] [--steps 4] [--json PATH]

``align``: kernel 2 (``csrc/windowed_align.cu``) at B=16, R=100 detections
an image, P=14, S=2, C=256 bf16 over P2..P5 of an 800x1088 input, through
its compiled P=14 instance and through the generic instance (runtime loop
bounds) of the same source, built beside it with the P=14 branch taken out
(:func:`build_generic`): both outputs bitwise, against the plain version in
f32, and timed in turns (P=14, generic, generic, P=14; 50 launches each,
CUDA events), with the bound of ``port_bench/counts.py``.

``train``: ``train_step`` micro-steps of the configuration (bf16, the
hybrid RoIAlign, the mask loss on 128 positive rois an image) on seeded
800x1088 images with COCO-shaped boxes and a star-convex polygon in each:
without augmentation (the reference reads the same pixels): the time of
each micro-step, the peak device memory, and the first
micro-step's gradient of ``mask_head.predictor`` against the plain
reference's (``port_bench/reference/mask_rcnn.py``, float32) on the same
sampled rois, labels and polygons, read from the program's mask head call.

Needs a CUDA device; the last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GENERIC_FROM = "(p == 14 && s == 2)"


def build_generic(out_dir: str):
    """Kernel 2's library with the P=14 instance taken out of the source, so
    that P=14 runs the generic instance: ``(launch function, ptxas log)``."""
    from two_stage_object_detection_tpu_torch.ops import _cuda
    src = (_cuda.SRC_DIR / "windowed_align.cu").read_text()
    if GENERIC_FROM not in src:
        raise RuntimeError(f"{GENERIC_FROM!r} not in windowed_align.cu")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "windowed_align_generic.cu")
    with open(cu, "w") as f:
        f.write(src.replace(GENERIC_FROM, "(false)"))
    lib = os.path.join(out_dir, "libwindowed_align_generic.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = _cuda.bind(ctypes.CDLL(lib), "windowed_align_launch")
    return fn, proc.stdout + proc.stderr


def launch(fn, pyr, rois, levels, scales, p: int, s: int = 2, win: int = 32):
    """One launch of ``fn`` (a ``windowed_align_launch``) as
    ``ops/windowed_align.py:windowed_align_op`` makes it."""
    import torch
    from two_stage_object_detection_tpu_torch.ops import _cuda
    b, r, _ = rois.shape
    c, n = pyr[0].shape[-1], len(pyr)
    out = torch.empty((b, r, p, p, c), dtype=pyr[0].dtype, device=rois.device)
    sc = [v for pair in scales for v in pair]
    status = fn((ctypes.c_void_p * n)(*[f.data_ptr() for f in pyr]),
                (ctypes.c_int * (2 * n))(*[d for f in pyr for d in f.shape[1:3]]),
                (ctypes.c_float * (2 * n))(*sc), n, rois.data_ptr(),
                levels.data_ptr(), out.data_ptr(), b, r, c, p, s, win, 0,
                _cuda.DTYPES[pyr[0].dtype],
                _cuda.align_vector_width(c, pyr[0].dtype),
                torch.cuda.current_stream(rois.device).cuda_stream)
    _cuda.check(status, "windowed_align_launch (generic)")
    return out


def detection_rois(b: int, r: int, h: int, w: int, gen, device):
    """COCO-like detections: square-root areas log-uniform in [16, 600] px,
    aspect 0.5-2, inside the image."""
    import torch
    u = torch.rand((b, r, 4), generator=gen, device=device)
    side = torch.exp(u[..., 0] * (torch.log(torch.tensor(600.0)) -
                                  torch.log(torch.tensor(16.0)))) * 16.0
    ar = torch.exp((u[..., 1] - 0.5) * 1.386)
    bw = torch.clamp(side / ar.sqrt(), max=w - 1.0)
    bh = torch.clamp(side * ar.sqrt(), max=h - 1.0)
    x1, y1 = u[..., 2] * (w - bw), u[..., 3] * (h - bh)
    return torch.stack([x1, y1, x1 + bw, y1 + bh], -1).contiguous()


def align(args) -> dict:
    import torch
    from port_bench import counts
    from two_stage_object_detection_tpu_torch.nets.fpn import (
        fpn_level_assign, span_aware_levels)
    from two_stage_object_detection_tpu_torch.ops import _cuda
    from two_stage_object_detection_tpu_torch.ops.windowed_align import (
        windowed_roi_align_batched)
    dev = torch.device("cuda")
    _cuda.build_all()
    spec = _cuda.entry("windowed_align_launch")
    generic, log = build_generic(os.path.join(str(_cuda.BUILD_ROOT),
                                              "generic_p14"))
    h, w, b, r, c = 800, 1088, 16, 100, 256
    hw = [(200, 272), (100, 136), (50, 68), (25, 34)]
    scales = [(fh / h, fw / w) for fh, fw in hw]
    gen = torch.Generator(device=dev).manual_seed(1400)
    pyr = [torch.randn((b, fh, fw, c), generator=gen, device=dev)
           .to(torch.bfloat16) for fh, fw in hw]
    rois = detection_rois(b, r, h, w, gen, dev)
    lv = fpn_level_assign(rois, 2, 5) - 2
    levels = span_aware_levels(rois, lv, scales, 30.0).contiguous()
    out = {"ptxas_generic": log[-2000:]}
    got = {k: launch(fn, pyr, rois, levels, scales, 14)
           for k, fn in (("p14", spec), ("generic", generic))}
    plain = windowed_roi_align_batched([t.float() for t in pyr], rois, levels,
                                       scales, 14, 2, use_kernel=False)
    torch.cuda.synchronize()
    out["bitwise_p14_generic"] = bool(torch.equal(got["p14"], got["generic"]))
    out["max_abs_vs_plain_f32"] = float((got["p14"].float() - plain).abs().max())
    out["max_rel_vs_plain_f32"] = float(
        ((got["p14"].float() - plain).abs() / (plain.abs() + 1e-3)).max())
    times = {"p14": [], "generic": []}
    for turn in ("p14", "generic", "generic", "p14"):
        fn = spec if turn == "p14" else generic
        for _ in range(5):
            launch(fn, pyr, rois, levels, scales, 14)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(50):
            launch(fn, pyr, rois, levels, scales, 14)
        e1.record()
        torch.cuda.synchronize()
        times[turn].append(e0.elapsed_time(e1) / 50)
    out["ms"] = times
    pk = counts.peaks(torch.cuda.get_device_name(0))
    out["bound_ms"] = counts.align_bound_ms(pyr, rois, levels, scales, 14, 32,
                                            pk) if pk else None
    out["shape"] = {"b": b, "r": r, "p": 14, "c": c, "levels": hw}
    return out


def star_polygons(boxes, valid, v: int, rng):
    """One star-convex ring of 6-12 vertices inside each valid box, packed as
    the data path packs it (``data/coco.py:pack_polygon``)."""
    import numpy as np
    from two_stage_object_detection_tpu_torch.data.coco import pack_polygon
    b, g, _ = boxes.shape
    polys = np.zeros((b, g, v, 2), np.float32)
    edges = np.zeros((b, g, v), bool)
    for i in range(b):
        for j in range(g):
            if not valid[i, j]:
                continue
            x1, y1, x2, y2 = boxes[i, j]
            k = int(rng.integers(6, 13))
            ang = 2 * np.pi * (np.arange(k) + rng.random(k)) / k
            rad = rng.uniform(0.55, 1.0, k)
            ring = np.stack([(x1 + x2) / 2 + rad * np.cos(ang) * (x2 - x1) / 2,
                             (y1 + y2) / 2 + rad * np.sin(ang) * (y2 - y1) / 2],
                            -1).astype(np.float32)
            polys[i, j], edges[i, j] = pack_polygon([ring], v)
    return polys, edges


def train(args) -> dict:
    import numpy as np
    import torch
    from port_bench import inputs
    from port_bench.reference import config as ref_config
    from port_bench.reference.mask_rcnn import (
        MaskRCNN, init_mask_head, mask_bce, rasterize)
    from port_bench.reference.layers import init_weights
    from port_bench.reference.geometry import bbox_iou
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.ops import _cuda
    dev = torch.device("cuda")
    _cuda.build_all()
    spec = json.load(open(os.path.join(ROOT, "port_bench", "configs",
                                       "mask_r50.json")))
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in spec["config"].items()}
    gt_spec = json.load(open(os.path.join(ROOT, "port_bench", "traffic",
                                          "resident16.json")))["ground_truth"]
    b, seed = args.batch, 1800
    cfg = Config(**kw, batch_size=b, device="cuda")
    h, w = cfg.input_size
    rkw = {k: v for k, v in kw.items()
           if k in {f.name for f in ref_config.dataclasses.fields(ref_config.Config)}}
    rcfg = ref_config.Config(**{**rkw, "compute_dtype": "float32"})
    mk = {k: kw[k] for k in ("mask_roi_size", "mask_dim", "mask_convs")}
    ref = MaskRCNN(rcfg, **mk, device=dev)
    init_weights(ref, inputs.sub_seed(seed, 0))
    init_mask_head(ref.mask_head, inputs.sub_seed(seed, 0, 1))
    model, state = create_train_state(cfg, device="cuda")
    model.load_state_dict(ref.state_dict())
    ref.cpu()
    images = inputs.images_u8(b, h, w, inputs.device_generator(seed, dev, 1))
    boxes, labels, valid = inputs.gt_boxes(b, gt_spec, h, w, cfg.num_classes,
                                           cfg.max_gt_boxes, seed)
    polys, edges = star_polygons(boxes, valid, cfg.max_mask_vertices,
                                 inputs.rng(seed, 3))
    batch = {"image": images, "boxes": torch.from_numpy(boxes).to(dev),
             "labels": torch.from_numpy(labels).to(dev),
             "valid": torch.from_numpy(valid).to(dev),
             "polys": torch.from_numpy(polys).to(dev),
             "poly_edges": torch.from_numpy(edges).to(dev)}
    seen = {}

    def grab(module, args):
        seen.setdefault("args", args)

    hook = model.mask_head.register_forward_pre_hook(grab)
    torch.cuda.reset_peak_memory_stats()
    out = {"batch": b, "device": torch.cuda.get_device_name(0)}
    steps = []
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = train_step(state, batch, None, device_augment=False)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        if i == 0:
            hook.remove()
            g_prog = model.mask_head.predictor.weight.grad.detach().clone()
            out["losses"] = {k: float(v) for k, v in losses.items()}
    out["micro_step_s"] = steps
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    # the reference's gradient on the program's sampled rois and labels
    feats_p, rois, lab, img = seen["args"][:4]
    rois, lab = rois.detach().float(), lab.detach()
    del state, model, feats_p, seen
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref.to(dev).to(memory_format=torch.channels_last)
    x = images.float() / 255.0
    with torch.no_grad():
        ref.train()
        feats = ref.features(x)
    gv = batch["valid"]
    iou = torch.where(gv[:, None, :], bbox_iou(rois, batch["boxes"]), -1.0)
    _, index = iou.max(2)
    edges_t = batch["poly_edges"]
    ok = (lab > 0) & edges_t.any(-1).gather(1, index)
    target = rasterize(batch["polys"], edges_t, index, rois,
                       2 * ref.mask_head.roi_size)
    ref.mask_head.zero_grad()
    loss = mask_bce(ref.mask_head([f.detach() for f in feats], rois, lab,
                                  img, use_window=False), target, ok)
    loss.backward()
    g_ref = ref.mask_head.predictor.weight.grad
    out["ref_mask_loss"] = float(loss.detach())
    out["predictor_grad_rel_err"] = float((g_prog - g_ref).norm() / g_ref.norm())
    out["predictor_grad_norms"] = [float(g_prog.norm()), float(g_ref.norm())]
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_mask_rcnn.py")
    ap.add_argument("what", choices=("align", "train"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    out = align(args) if args.what == "align" else train(args)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
