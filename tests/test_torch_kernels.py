"""PyTorch port, the CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and ``nvcc`` (the kernels build from
``two_stage_object_detection_tpu_torch/csrc`` at first use); without a GPU
they skip.  Run them on the GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest sets up JAX, which that machine
need not have; this file imports nothing of JAX.)

``chip_smoke.py`` repeats these checks at the predict path's full shapes.
"""

import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu_torch.ops.proposals import (
    greedy_nms, greedy_nms_rows_reference)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    windowed_roi_align_batched)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_rows(rng, b, k):
    xy = rng.rand(b, k, 2) * 200.0
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 80 + 4], -1)
    scores = rng.randint(0, 30, size=(b, k)) / 30.0
    scores[:, -k // 10:] = -1e9
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1).astype(np.float32)
    scores = np.take_along_axis(scores, order, 1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("k,n_post", [(1, 1), (64, 8), (130, 40), (3000, 300)])
def test_greedy_nms_kernel_bitwise_equals_plain(rng, dev, k, n_post):
    boxes, scores = _sorted_rows(rng, 3, k)
    boxes, scores = boxes.to(dev), scores.to(dev)
    before = greedy_nms.launches
    got = greedy_nms(boxes, scores, n_post=n_post, iou_threshold=0.7)
    want = greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                     iou_threshold=0.7)
    torch.cuda.synchronize()
    assert greedy_nms.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_greedy_nms_kernel_rejects_bad_input(dev):
    boxes = torch.zeros((1, 8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        greedy_nms(boxes, torch.zeros((1, 8), device=dev), n_post=2,
                   iou_threshold=0.5)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 32), (torch.float32, 300),
                                     (torch.bfloat16, 256)])
def test_windowed_align_kernel_matches_plain(rng, dev, dtype, c):
    """f32: <= 1e-5 (summation order); bf16: within one bf16 rounding of
    the plain version run in f32 on the same bf16 features."""
    hw = [(40, 40), (20, 20), (10, 10), (5, 5)]
    scales = tuple((h / 160.0, w / 160.0) for h, w in hw)
    pyr = [torch.randn(2, h, w, c, device=dev).to(dtype) for h, w in hw]
    x1 = torch.from_numpy(rng.rand(2, 20, 2).astype(np.float32) * 170 - 10)
    wh = torch.from_numpy(rng.rand(2, 20, 2).astype(np.float32) * 150 + 2)
    rois = torch.cat([x1, x1 + wh], -1).to(dev)
    levels = torch.from_numpy(rng.randint(0, 4, (2, 20)).astype(np.int32)).to(dev)
    got = windowed_roi_align_batched(pyr, rois, levels, scales)
    want = windowed_roi_align_batched([p.float() for p in pyr], rois, levels,
                                      scales, use_kernel=False)
    diff = (got.float() - want).abs()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * want.abs() + 1e-5
    assert bool((diff <= tol).all()), float(diff.max())
