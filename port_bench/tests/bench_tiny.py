"""Tiny sizes at which the benchmark's drivers run on the CPU in a test."""

import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = dict(input_size=(64, 64), num_classes=3, n_train_pre_nms=128,
            n_train_post_nms=32, n_test_pre_nms=64, n_test_post_nms=16,
            roi_n_sample=8, rpn_n_sample=32, max_detections=8, max_gt_boxes=4,
            compute_dtype="float32")
TRAFFIC = {
    "serve_closed_loop": dict(images_per_request=4, pool_requests=2,
                              check_images=4, batch_sizes=[1, 2],
                              trace_slice={"start_frac": 0.2, "seconds": 0.3}),
    "train_resident": dict(batch_size=2, grad_accum_steps=2,
                           cache_bytes=64 * 64 * 3 * 16, reference_updates=2),
}
# long enough for a request or a cycle to end inside the window on a busy
# CPU
SECONDS = {"serve_closed_loop": 4.0, "train_resident": 8.0}


def tiny_run(name: str, seed: int = 2 ** 33 + 7, trace: int = 0,
             root: str = ROOT):
    """A CPU run of cell ``name`` at the tiny sizes: ``(run, driver)``."""
    import torch
    from port_bench import harness
    from port_bench.runner import Run
    torch.set_num_threads(2)
    cell = harness.Cell(root, name)
    kind = cell.traffic["driver"]
    cell.traffic = {**cell.traffic, **TRAFFIC[kind]}
    run = Run(root, cell, seed, SECONDS[kind], trace, time.time(), "cpu",
              overrides=TINY)
    return run, cell.driver()
