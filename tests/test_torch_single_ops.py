"""PyTorch port, the single-scale path's ops: the plain versions of kernel 3
(whole-table fused proposals), kernel 4 (its one-image form) and kernel 5
(RoIPool max with argmax) against the JAX package's Pallas kernels run
interpreted (``interpret=True``, as the JAX package's own tests run them),
in float32 on the CPU.

The CUDA kernels cannot run here; they are held against these plain
versions on the GPU (``tests/test_torch_kernels.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.ops.pallas_proposals import (
    fused_proposals as j_fused, fused_proposals_batched as j_fused_batched)
from two_stage_object_detection_tpu.ops.pallas_roi import _roi_pool_fwd_impl
from two_stage_object_detection_tpu.ops.roi_pool import roi_pool as j_roi_pool
from two_stage_object_detection_tpu_torch.ops import proposals as tp
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_pool, roi_pool_argmax)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import roi_pool_max
from two_stage_object_detection_tpu_torch.utils.profiling import counters

T = torch.from_numpy
IMG = (128, 160)          # (H, W)


# ---------------------------------------------- kernels 3/4: proposals
def _proposal_inputs(rng, b, n=600):
    """``n`` anchors of 10..70 px, some over the image edge, with coarse
    scores (ties) and rows shrunk under the min size.  Rows ``3k`` and
    ``3k+1`` share an anchor: ``3k`` decodes to it exactly and ``3k+1`` to
    it shifted along x by ``d = aw * 0.3/1.7 * (1 +- 1e-5)``, an IoU within
    ~1e-5 of 0.7; ``dw = dh = 0`` keeps ``exp`` exact on both sides."""
    xy = rng.rand(n, 2) * np.array([IMG[1], IMG[0]]) * 0.95
    anchors = np.concatenate([xy, xy + rng.rand(n, 2) * 60 + 10], -1)
    anchors[1::3] = anchors[0::3]
    locs = rng.randn(b, n, 4) * 0.2
    locs[:, 0::3] = 0.0
    locs[:, 1::3] = 0.0
    locs[:, 1::3, 0] = 0.3 / 1.7 * (1.0 + rng.uniform(-1e-5, 1e-5, (b, n // 3)))
    locs[:, 2::12, 2:] = -4.0                     # shrunk under min_size
    fg = rng.randint(0, 40, size=(b, n)) / 40.0
    return (anchors.astype(np.float32), locs.astype(np.float32),
            fg.astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_proposals_equal(got, want):
    """Equal valid and scores; boxes within 1e-4 px (the two ``exp``s)."""
    gb, gs, gv = (t.numpy() for t in got)
    wb, ws, wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)


def test_fused_proposals_plain_matches_pallas_batched(rng):
    """Kernel 3's plain version == the interpreted ``_batched_kernel``."""
    anchors, locs, fg = _proposal_inputs(rng, b=2)
    kw = dict(nms_iou=0.7, n_post_nms=48, min_size=8.0)
    want = j_fused_batched(jnp.asarray(locs), jnp.asarray(fg),
                           jnp.asarray(anchors), IMG, interpret=True, **kw)
    got = tp.fused_proposals_rows_reference(T(locs), T(fg), T(anchors), IMG,
                                            **kw)
    _assert_proposals_equal(got, want)
    assert got[2].numpy().sum(1).min() > 0
    # the wrapper runs the plain version on CPU tensors and launches nothing
    before = counters["launch.fused_proposals_batched"]
    again = tp.fused_proposals_batched(T(locs), T(fg), T(anchors), IMG, **kw)
    assert counters["launch.fused_proposals_batched"] == before
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_fused_proposals_one_image_matches_pallas_fused(rng):
    """Kernel 4 (the one-image form) == the interpreted ``_fused_kernel``."""
    anchors, locs, fg = _proposal_inputs(rng, b=1)
    kw = dict(nms_iou=0.7, n_post_nms=32, min_size=8.0)
    want = j_fused(jnp.asarray(locs[0]), jnp.asarray(fg[0]),
                   jnp.asarray(anchors), IMG, interpret=True, **kw)
    before = counters["launch.fused_proposals"]
    got = tp.fused_proposals(T(locs[0]), T(fg[0]), T(anchors), IMG, **kw)
    assert counters["launch.fused_proposals"] == before
    assert got[0].shape == (32, 4) and got[2].shape == (32,)
    _assert_proposals_equal(got, want)


@pytest.mark.parametrize("n_pre", [100, 101])
def test_proposal_route_follows_jax(rng, n_pre):
    """At N = 600 the pre-NMS cut engages for n_pre = 100 (6 * 100 <= 600)
    and not for 101; on both sides of the line the port takes the JAX
    package's route (``fused_proposals_batched``) and gives its outputs."""
    anchors, locs, fg = _proposal_inputs(rng, b=2)
    kw = dict(nms_iou=0.5, n_post_nms=96, min_size=8.0)
    want = j_fused_batched(jnp.asarray(locs), jnp.asarray(fg),
                           jnp.asarray(anchors), IMG, n_pre_nms=n_pre,
                           interpret=True, **kw)
    got = tp.proposals_batched(T(locs), T(fg), T(anchors), IMG,
                               n_pre_nms=n_pre, **kw)
    _assert_proposals_equal(got, want)
    whole = tp.fused_proposals_rows_reference(T(locs), T(fg), T(anchors), IMG,
                                              **kw)
    # the cut runs out of candidates here (zeroed tail), so the routes differ
    same = all(torch.equal(a, b) for a, b in zip(got, whole))
    assert same == (6 * n_pre > 600)
    assert got[2].numpy().sum(1).max() < 96 or 6 * n_pre > 600


# ------------------------------------------------ kernel 5: RoIPool max
def _pool_inputs(rng, b=2, h=12, w=10, c=8, r=20):
    """Maps with a constant patch (ties across a whole bin) and coarse
    values (ties inside bins); rois of all sizes at scale 1/16, some partly
    off the map, one entirely off it, and one over the left edge whose
    first bins clamp to nothing (x from -2.5 and to 1.5 cells: half to
    even gives -2..2)."""
    feats = (rng.randint(-8, 8, size=(b, h, w, c)) / 4.0).astype(np.float32)
    feats[:, 2:7, 1:6, :] = 0.75
    xy = rng.rand(b, r, 2) * np.array([w, h]) * 16 * 1.1 - 16
    wh = rng.rand(b, r, 2) * np.array([w, h]) * 16 * 0.8 + 4
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [2 * 16, 2 * 16, 6 * 16, 7 * 16]        # the tied patch
    rois[:, 1] = [-400, -300, -200, -100]                # off the map
    rois[:, 2] = [-40, 16, 24, 80]                       # empty first bins
    return feats, rois


def test_roi_pool_argmax_matches_pallas_kernel(rng):
    """Kernel 5's plain version == the interpreted ``_roi_pool_kernel``:
    values and argmax equal, empty bins 0 and -1."""
    feats, rois = _pool_inputs(rng)
    pooled, idx = roi_pool_argmax(T(feats), T(rois), 7, 1.0 / 16)
    assert pooled.dtype == torch.float32 and idx.dtype == torch.int32
    assert pooled.shape == (2, 20, 7, 7, 8)
    for i in range(2):
        wv, wi = _roi_pool_fwd_impl(jnp.asarray(feats[i]), jnp.asarray(rois[i]),
                                    7, 1.0 / 16, True)
        np.testing.assert_array_equal(pooled[i].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))
    idx = idx.numpy()
    assert (idx[:, 1] == -1).all() and (pooled.numpy()[:, 1] == 0).all()
    assert (idx[:, 2] == -1).any() and (idx[:, 2] >= 0).any()
    # the tied patch: every bin's argmax is its first pixel in row-major order
    assert (idx[:, 0, 0, 0] == 2 * 10 + 2).all()


def test_roi_pool_matches_jax_roi_pool(rng):
    """The plain RoIPool max == the JAX package's masked-max ``roi_pool``
    (vmapped), in f32 and from bf16 maps (pooled in f32, exact)."""
    feats, rois = _pool_inputs(rng, c=16, r=12)
    want = jax.vmap(lambda f, q: j_roi_pool(f, q, 7, 1.0 / 16))(feats, rois)
    got = roi_pool(T(feats), T(rois), 7, 1.0 / 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf = T(feats).to(torch.bfloat16)
    want_bf = jax.vmap(lambda f, q: j_roi_pool(f, q, 7, 1.0 / 16))(
        jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), rois)
    np.testing.assert_array_equal(roi_pool(bf, T(rois), 7, 1.0 / 16).numpy(),
                                  np.asarray(want_bf.astype(jnp.float32)))


def test_roi_pool_max_wrapper_uses_plain_version_on_cpu(rng):
    feats, rois = _pool_inputs(rng, b=1, r=4)
    before = counters["launch.roi_pool_max"]
    got = roi_pool_max(T(feats), T(rois), 7, 1.0 / 16)
    want = roi_pool_argmax(T(feats), T(rois), 7, 1.0 / 16)
    assert counters["launch.roi_pool_max"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
