"""PyTorch port: the plan of the RoIPool backward kernels, on the CPU.

Kernel 6 (``ops/roi_pool_bwd.py:roi_pool_bwd_recompute``) and kernel 5b
(``ops/roi_pool_max.py:roi_pool_bwd_scatter``) run one block a channel
slice and image on the slice route: the block holds the slice's f32
gradient (and for kernel 6 the map's slice and its rois' bin edges) in
shared memory and writes it once.  ``roi_pool_bwd_plan`` picks the slice
width by shape; a map whose narrowest slice does not fit takes the direct
route (global atomics).  The kernels run only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import pytest

from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    SLICE_SMEM_BYTES, roi_pool_bwd_plan)

N_SM = 132


# (b, h, w, c, map bytes a channel, kernel 6's route, 5b's route)
SHAPES = {
    "38x38x512_bf16": (16, 38, 38, 512, 2, "slice", "slice"),
    "38x38x512_f32": (16, 38, 38, 512, 4, "slice", "slice"),
    "64x64": (16, 64, 64, 512, 2, "slice", "slice"),
    "too_large": (2, 130, 120, 64, 2, "direct", "direct"),
    "c4": (16, 38, 38, 4, 2, "slice", "slice"),
    "c_ragged": (16, 38, 38, 260, 2, "slice", "slice"),
}


@pytest.mark.parametrize("kind", ["recompute", "scatter"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_roi_pool_bwd_plan(shape, kind):
    """The route; on the slice route, vectors of 16 bytes where a pixel's
    bytes allow (8 otherwise; kernel 5b's are 4 f32 channels), slices that
    cover every vector once (the last one may be narrower), the
    shared-memory bytes of the kernel's layout (kernel 6's gradient one
    float more a pixel than the slice) within the budget, and a grid that spreads the
    vectors over the SMs as evenly as one-vector slices would (its busiest
    SM holds ``ceil(b * cv / n_sm)``)."""
    b, h, w, c, elem, route6, route5b = SHAPES[shape]
    r, p = 128, 7
    plan = roi_pool_bwd_plan(kind, b, h, w, c, r, elem, N_SM, p)
    assert plan["route"] == (route6 if kind == "recompute" else route5b)
    if kind == "recompute":
        vec = 16 if c * elem % 16 == 0 else 8
        ch = vec // elem
        fixed = (r * 2 * p + p * p) * 4
    else:
        vec, ch, fixed = 16, 4, 0

    def smem(nv):
        if kind == "recompute":
            grad = -(-(h * w * (nv * ch + 1) * 4) // 16) * 16
            return -(-(h * w * nv * vec) // 16) * 16 + grad + fixed
        return h * w * nv * 16

    if plan["route"] == "direct":
        assert plan["nv"] == plan["n_slices"] == plan["smem_bytes"] == 0
        assert smem(1) > SLICE_SMEM_BYTES
        return
    assert plan["vec_bytes"] == vec
    cv, nv, n_slices = c // ch, plan["nv"], plan["n_slices"]
    assert (n_slices - 1) * nv < cv <= n_slices * nv
    assert plan["rois_per_pass"] == (r if kind == "recompute" else 0)
    assert plan["smem_bytes"] == smem(nv)
    assert plan["smem_bytes"] <= SLICE_SMEM_BYTES < 232448
    assert -(-(b * n_slices) // N_SM) * nv == -(-(b * cv) // N_SM)
    if shape == "38x38x512_bf16":
        # 16 channels a slice for kernel 6 (the map's and its gradient's
        # 6 bytes a pixel and channel), 32 for 5b; 512 and 256 blocks
        assert nv * ch == (16 if kind == "recompute" else 32)
        assert b * n_slices >= N_SM
    if shape == "c_ragged":
        assert cv % nv != 0                 # a narrower last slice


def test_roi_pool_bwd_plan_passes_many_rois():
    """More rois than the edge budget holds: kernel 6 computes their bin
    edges a pass at a time, every pass within the budget."""
    plan = roi_pool_bwd_plan("recompute", 16, 38, 38, 512, 2000, 2, N_SM, 7)
    assert plan["route"] == "slice" and 1 <= plan["rois_per_pass"] < 2000
    assert plan["smem_bytes"] <= SLICE_SMEM_BYTES


def test_roi_pool_bwd_plan_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        roi_pool_bwd_plan("gather", 1, 4, 4, 4, 1, 2)
