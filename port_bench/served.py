"""What the serving drivers share: the seeded image pool in the wire's
layout, the ``Predictor`` the traffic file describes, the reference's
detections of the same images, and the comparison of the two."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from port_bench import compare, inputs
from port_bench.harness import BenchError


def served_images(run, pcfg, n_pool: int, gen):
    """A pool of seeded images in the wire's layout, on the host."""
    h, w = pcfg.input_size
    if run.traffic["wire"] == "u8":
        return inputs.images_u8(n_pool, h, w, gen).cpu().numpy()
    raise BenchError(f"wire {run.traffic['wire']!r} has no generator")


def predictor(run, model, pcfg):
    from two_stage_object_detection_tpu_torch.serving import Predictor
    tr = run.traffic
    return Predictor(pcfg, model, batch_sizes=tuple(tr["batch_sizes"]),
                     calibrate=bool(tr["calibrate"]), wire=tr["wire"])


def reference_outputs(run, rcfg, wire_images: np.ndarray,
                      precision: str = None):
    """The reference's detections on ``wire_images`` (the wire's raw
    layout), in blocks: numpy ``boxes, scores, labels, valid`` and the
    candidates (:func:`~port_bench.compare.scored_detections`) a row.
    ``precision``: its products on ``"fp8"`` operands (the control)."""
    from port_bench.reference import wire
    from port_bench.reference.layers import low_precision
    run.free()
    run.reference_precision()
    ref = run.reference_model(rcfg)
    ref.keep_candidates = True
    block = int(run.traffic.get("reference_block", 4))
    names = ("boxes", "scores", "labels", "valid", "cand_boxes",
             "cand_scores", "cand_valid")
    outs = []
    with torch.inference_mode(), (low_precision(precision) if precision
                                  else contextlib.nullcontext()):
        for i in range(0, len(wire_images), block):
            x = wire.u8_to_float(
                torch.from_numpy(wire_images[i:i + block]).to(run.device))
            res = [t.cpu().numpy() for t in (*ref.predict(x), *ref.candidates)]
            outs += [dict(zip(names, (r[j] for r in res)))
                     for j in range(len(x))]
    del ref
    return outs


def detection_checks(run, rcfg, got: list, wire_images: np.ndarray):
    """``(correct, checks)`` of the served detections ``got`` of
    ``wire_images`` against the reference's (with ``run.control ==
    "fp8"``, the reference on float8 operands is served in the program's
    place)."""
    if run.control == "fp8":
        got = reference_outputs(run, rcfg, wire_images, "fp8")
    want = reference_outputs(run, rcfg, wire_images)
    s = compare.scored_detections(list(zip(got, want)))
    run.log(f"served detections against the reference over {len(got)} "
            f"images: {s['served']} served, {s['reference']} the "
            f"reference's, {s['found']} found among its decodes; score_gap "
            f"{s['score_gap']!r} (mean |score - reference score| of the "
            f"found), unfound_share {s['unfound_share']!r}, count_gap "
            f"{s['count_gap']!r}")
    return run.checks({"miss_share": s["miss_share"]})
