"""One caller sending many-image requests back to back to a Mask R-CNN
``Predictor``: images completed per second (``serve_img_per_s``), each
image's boxes and its detections' 28x28 masks.

Traffic file: as ``serve_closed_loop``'s (``wire``, ``batch_sizes``,
``calibrate``, ``images_per_request``, ``pool_requests``,
``check_images``, ``reference_block``, ``trace_slice``).

The program and the reference are built here from the seed: the box
detector's weights as ``Run.reference_model`` draws them, the mask head's
from a sub-seed of their own (``reference/mask_rcnn.py:init_mask_head``),
its predictor scaled to the configuration's ``mask_init_logit_std``.
``correct`` takes two readings of 32 served images: ``miss_share``
(``served.detection_checks``, the boxes) and ``mask_gap``: the served
masks against the reference's mask branch fed the served boxes and labels
on its own float32 features, so that the mask path is read apart from the
boxes' rounding.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from port_bench import counts_mask, inputs, served
from port_bench.harness import BenchError
from port_bench.runner import _logit_scales, clock
from port_bench.trace import PredictorProxy

MASK_KEYS = ("mask_roi_size", "mask_dim", "mask_convs")


def mask_kw(run) -> dict:
    return {k: run.model_kw[k] for k in MASK_KEYS}


def mask_reference(run, rcfg):
    """The reference Mask R-CNN, float32 on the device: the box detector's
    weights (and logit scales) of ``run.reference_model``, the mask head
    drawn from ``sub_seed(seed, 0, 1)`` and its predictor scaled so that
    its logits on four seeded images spread by the configuration's
    ``mask_init_logit_std`` (found once a run, kept in ``run.memo``)."""
    from port_bench.reference.mask_rcnn import MaskRCNN, init_mask_head
    box = run.reference_model(rcfg)
    ref = MaskRCNN(rcfg, **mask_kw(run), device=run.device)
    missing = ref.load_state_dict(box.state_dict(), strict=False).missing_keys
    del box
    if any(not k.startswith("mask_head.") for k in missing):
        raise BenchError(f"the box reference lacks {missing}")
    init_mask_head(ref.mask_head, inputs.sub_seed(run.seed, 0, 1))
    target = run.cell.config.get("mask_init_logit_std") or {}
    if "mask_scales" not in run.memo:
        run.memo["mask_scales"] = _logit_scales(ref, rcfg, target, run.seed)
        return ref
    with torch.no_grad():
        for name, k in run.memo["mask_scales"].items():
            ref.get_submodule(name).weight.mul_(k)
    return ref


def program_model(run, pcfg, rcfg):
    """The program's Mask R-CNN with the reference's weights (kernels built
    first)."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    if run.cuda:
        from two_stage_object_detection_tpu_torch.ops import _cuda
        _cuda.build_all()
    model = FasterRCNN(pcfg, device=run.device)
    ref = mask_reference(run, rcfg)
    model.load_state_dict(ref.state_dict())
    del ref
    return model


def mask_checks(run, rcfg, got: list, wire_images: np.ndarray):
    """``(correct, checks)`` of ``mask_gap``: over the valid served
    detections of ``got``, the mean of each mask's mean ``|p - p_ref|``
    over its bins, divided by the mean of its mean ``|p_ref - 0.5|``;
    ``p_ref`` the reference's mask branch on the same boxes and labels, on
    the reference's float32 features of the served bytes.  With
    ``run.control == "fp8"`` the reference on float8 operands serves the
    boxes and masks in the program's place."""
    from port_bench.reference import wire
    from port_bench.reference.layers import low_precision
    run.free()
    run.reference_precision()
    ref = mask_reference(run, rcfg)
    block = int(run.traffic.get("reference_block", 4))
    gap = spread = 0.0
    n = 0
    with torch.inference_mode():
        for i in range(0, len(wire_images), block):
            x = wire.u8_to_float(torch.from_numpy(
                wire_images[i:i + block]).to(run.device))
            img = tuple(x.shape[1:3])
            if run.control == "fp8":
                with low_precision("fp8"):
                    boxes, _, labels, valid, masks = ref.predict(x)
            else:
                g = got[i:i + block]
                boxes, labels, valid, masks = (
                    torch.from_numpy(np.stack([o[k] for o in g])).to(run.device)
                    for k in ("boxes", "labels", "valid", "masks"))
            want = ref.mask_predict(ref.features(x), boxes, labels,
                                    valid.bool(), img)
            v = valid.bool()
            gap += float((masks.float() - want).abs().mean((-2, -1))[v].sum())
            spread += float((want - 0.5).abs().mean((-2, -1))[v].sum())
            n += int(v.sum())
    del ref
    reading = gap / spread if spread else 0.0
    run.log(f"served masks against the reference's mask branch on the same "
            f"boxes over {len(wire_images)} images: {n} detections, mean "
            f"|p - p_ref| {gap / max(n, 1)!r}, mean |p_ref - 0.5| "
            f"{spread / max(n, 1)!r}, mask_gap {reading!r}")
    return run.checks({"mask_gap": reading})


def drive(run) -> dict:
    tr = run.traffic
    try:
        pcfg = run.program_config()
    except TypeError as e:
        raise BenchError(f"the program has no mask head: {e}") from e
    rcfg = run.reference_config()
    model = program_model(run, pcfg, rcfg)
    per = int(tr["images_per_request"])
    pool = served.served_images(run, pcfg, per * int(tr["pool_requests"]),
                                inputs.device_generator(run.seed, run.device, 4))
    requests = pool.reshape(-1, per, *pool.shape[1:])
    order = inputs.rng(run.seed, 5)
    pred = served.predictor(run, model, pcfg)
    proxy = PredictorProxy(pred, clock)
    for r in requests:                     # warm: each bucket plan once
        proxy(r)
    if run.trace:
        run.install_spans(model)
        run.spans.modules(model, ("mask_head",))
        run.spans.method(model, "mask_predict")
    proxy.calls.clear()
    sl = tr.get("trace_slice", {})
    run.settle()
    t0 = clock()
    run.setup_done(t0)
    done, last_end, images, started = [], t0, 0, 0
    slicing = sliced = False
    slice_t = slice_end = None
    while True:
        now = clock()
        if now - t0 >= run.seconds:
            break
        if run.trace and not slicing and not sliced and (
                now - t0 >= sl["start_frac"] * run.seconds):
            run.start_slice()
            slicing, sliced, slice_t = True, True, now
        k = int(order.integers(len(requests)))
        started += 1
        out = proxy(requests[k])
        end = clock()
        if slicing and end - slice_t >= sl["seconds"]:
            run.stop_slice()
            slicing, slice_end = False, clock()
        if end - t0 <= run.seconds:
            done.append((k, out))
            images += per
            last_end = end
    if slicing:
        run.stop_slice()
        slice_end = clock()
    run.read_slice()
    peak = run.memory_peak()
    if not done:
        raise BenchError("no request completed inside the window")
    rate = images / (last_end - t0)
    run.log(f"{len(done)} requests of {per} images in "
            f"{last_end - t0!r} s: {rate!r} img/s; set-up {run.setup_s!r} s; "
            f"peak memory {peak} bytes")
    metrics = {"serve_img_per_s": rate, "setup_s": run.setup_s}
    breakdown = None
    if run.trace:
        outside = [c for c in proxy.calls
                   if slice_t is None or c[1] <= slice_t or c[0] >= slice_end]
        unsliced_s = (last_end - t0 - (slice_end - slice_t)) if slice_t else None
        ctx = SimpleNamespace(
            bounds=run.kernel_bounds(),
            flops_per_image=counts_mask.model_flops(rcfg, mask_kw(run)),
            rate=(sum(c[2] for c in outside if c[1] <= last_end) / unsliced_s)
            if unsliced_s else None)
        metrics = run.per_layer(ctx)
        breakdown = run.breakdown()
        run.spans.close()
    rng = inputs.rng(run.seed, 6)
    flat = [(s, j) for s in range(len(done)) for j in range(per)]
    pick = rng.choice(len(flat), size=min(int(tr["check_images"]), len(flat)),
                      replace=False)
    got, wire_imgs = [], []
    for p in sorted(pick):
        s, j = flat[p]
        k, out = done[s]
        got.append({f: v[j] for f, v in out.items()})
        wire_imgs.append(requests[k][j])
    del proxy, pred, model, done
    wire_imgs = np.stack(wire_imgs)
    ok_boxes, checks = served.detection_checks(run, rcfg, got, wire_imgs)
    ok_masks, more = mask_checks(run, rcfg, got, wire_imgs)
    return dict(correct=ok_boxes and ok_masks, attempted=started, failed=0,
                metrics=metrics, device=run.device_entry(peak),
                breakdown=breakdown, checks={**checks, **more})
