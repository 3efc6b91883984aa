"""PyTorch port: the plain versions of kernels 1 and 2 at the edges their
CUDA kernels' tiles and vectors meet, against the JAX package in float32 on
the CPU, and the Python that plans those kernels' launches.

Kernel 1 (``csrc/nms.cu``) walks its rows in tiles of 64 over a cluster of
up to 8 blocks; kernel 2 (``csrc/windowed_align.cu``) loads each pixel in
channel vectors whose width divides C.  The kernels themselves run only on
the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``), where they
are held against these plain versions; here the plain versions are held
against the interpreted Pallas ``_truncated_nms_call`` and the JAX
``multilevel_roi_align``.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.nets.fpn import fpn_level_assign as j_level
from two_stage_object_detection_tpu.ops.pallas_proposals import (
    _truncated_nms_call)
from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops import roi_pool as tr
from two_stage_object_detection_tpu_torch.ops.proposals import (
    MAX_KERNEL_ROWS, NMS_MAX_CLUSTER, NMS_TILE, greedy_nms_rows_reference,
    nms_cluster_size)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    windowed_roi_align_batched)

jr = importlib.import_module("two_stage_object_detection_tpu.ops.roi_pool")
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------- kernel 1: greedy NMS rows
def _rows(rng, b, k, n_valid):
    """Score-sorted rows (stable, ties by lower index) in a 120 px square,
    with near-threshold (IoU ~ 0.7) pairs; image i keeps ``n_valid[i]``
    valid rows, the rest masked (-1e9)."""
    xy = rng.rand(b, k, 2) * 120.0
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 60.0 + 1.0], -1)
    partner = boxes[:, 0:k:4][:, :len(range(1, k, 4))].copy()
    d = ((partner[..., 2] - partner[..., 0]) * (0.3 / 1.7)
         * (1.0 + rng.uniform(-1e-6, 1e-6, partner.shape[:2])))
    partner[..., 0] += d
    partner[..., 2] += d
    boxes[:, 1:k:4] = partner
    scores = rng.randint(0, 20, size=(b, k)) / 20.0
    for i, n in enumerate(n_valid):
        scores[i, n:] = -1e9
    order = np.argsort(-scores, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1).astype(np.float32),
            np.take_along_axis(scores, order, 1).astype(np.float32))


@pytest.mark.parametrize("k,n_post,n_valid", [
    (65, 16, (60, 65)),            # one row past a tile
    (130, 40, (130, 100)),         # two rows past two tiles
    (1000, 100, (1000, 950)),      # 15 tiles and a ragged 16th
    (130, 16, (0, 130)),           # an image with every row masked
    (200, 64, (200, 12)),          # fewer survivors than n_post
    (65, 65, (65, 65)),            # n_post = K
], ids=["k65", "k130", "k1000", "all_masked", "few_survivors", "n_post_eq_k"])
def test_greedy_nms_rows_edges_match_pallas_kernel(rng, k, n_post, n_valid):
    """Kernel 1's plain version == the interpreted Pallas
    ``_batched_nms_kernel`` where kernel 1's tiles meet: exact valid mask
    and scores, boxes <= 1e-6; invalid slots are zero."""
    boxes, scores = _rows(rng, 2, k, n_valid)
    jb, js, jv = _truncated_nms_call(jnp.asarray(boxes), jnp.asarray(scores),
                                     nms_iou=0.7, n_post_nms=n_post,
                                     interpret=True)
    tb, ts, tv, _ = greedy_nms_rows_reference(
        T(boxes), T(scores), n_post=n_post, iou_threshold=0.7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    kept = tv.numpy().sum(1)
    assert (tb.numpy()[~tv.numpy()] == 0).all() and (ts.numpy()[~tv.numpy()] == 0).all()
    for i, n in enumerate(n_valid):
        assert (kept[i] == 0) == (n == 0)
        assert kept[i] <= min(n, n_post)
    if n_valid[1] < n_post:
        assert kept[1] < n_post


@pytest.mark.parametrize("k,cluster", [(1, 1), (64, 1), (65, 2), (130, 3),
                                       (512, 8), (3000, 8), (12000, 8),
                                       (MAX_KERNEL_ROWS, 8)])
def test_nms_cluster_size(k, cluster):
    """One block per 64-row tile, at most 8; at the row cap each block's
    boxes and alive bits fit in the 227 KB a block can have."""
    assert nms_cluster_size(k) == cluster
    tiles = -(-k // NMS_TILE)
    per_block = -(-tiles // cluster)
    assert cluster <= NMS_MAX_CLUSTER and per_block * cluster >= tiles
    assert per_block * (NMS_TILE * 16 + 8) <= 227 * 1024


@pytest.mark.parametrize("k", [0, MAX_KERNEL_ROWS + 1])
def test_nms_cluster_size_rejects_rows_outside_the_cap(k):
    assert MAX_KERNEL_ROWS >= 28000
    with pytest.raises(ValueError, match="rows per image"):
        nms_cluster_size(k)


# --------------------------------------- kernel 2: windowed RoIAlign
def _every_level(rng, b=2, r=32, c=12, img=160.0):
    """Pyramid of a 160 px image; rois sized for each of the four levels
    (eq. 1 sends 64, 128, 300, 500 px to P2..P5); the 64 px ones of aspect
    8-20, whose windows on P2 do not cover them; some over the image edge."""
    hw = [(40, 40), (20, 20), (10, 10), (5, 5)]
    pyr = [rng.rand(b, h, w, c).astype(np.float32) for h, w in hw]
    side = np.tile(np.array([64.0, 128.0, 300.0, 500.0]), (b, r // 4))
    ar = rng.uniform(0.5, 2.0, size=(b, r))
    ar[:, ::4] = rng.uniform(8.0, 20.0, size=(b, r // 4))
    x1 = rng.rand(b, r) * img * 0.8 - img * 0.1
    y1 = rng.rand(b, r) * img * 0.8 - img * 0.1
    rois = np.stack([x1, y1, x1 + side * np.sqrt(ar), y1 + side / np.sqrt(ar)],
                    -1).astype(np.float32)
    levels = np.array(jax.vmap(lambda q: j_level(q, 2, 5) - 2)(rois))
    return pyr, rois, levels, hw


def test_multilevel_roi_align_ragged_channels_every_level(rng):
    """Kernel 2's plain version == JAX ``multilevel_roi_align`` vmapped at
    C=12 (a channel count kernel 2 loads in 8-byte bf16 or 16-byte f32
    vectors), with rois on every level, uncovered ones included:
    <= 1e-5 (float32 summation order)."""
    pyr, rois, levels, hw = _every_level(rng)
    scales = tuple((h / 160.0, w / 160.0) for h, w in hw)
    want = jax.vmap(lambda pi, ri, li: jr.multilevel_roi_align(
        pi, ri, li, scales, 7, window=32))(tuple(pyr), rois, levels)
    got = windowed_roi_align_batched([T(p) for p in pyr], T(rois),
                                     T(levels.astype(np.int32)), scales, 7,
                                     window=32)
    assert got.shape == (2, 32, 7, 7, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert set(np.unique(levels)) == {0, 1, 2, 3}
    cov = tr.window_coverage(T(rois), T(levels), hw, scales)
    assert not cov.all() and cov.any()


@pytest.mark.parametrize("dtype,c,vec", [
    (torch.bfloat16, 256, 8), (torch.bfloat16, 260, 4),
    (torch.bfloat16, 12, 4), (torch.bfloat16, 6, 2), (torch.bfloat16, 7, 1),
    (torch.float32, 256, 4), (torch.float32, 30, 2), (torch.float32, 12, 4),
    (torch.float32, 5, 1)])
def test_align_vector_width(dtype, c, vec):
    """The widest 16/8/4/2-byte vector that divides a pixel's channels: C
    is a whole number of vectors, and each pixel of an aligned map starts on
    one."""
    assert _cuda.align_vector_width(c, dtype) == vec
    size = torch.empty((), dtype=dtype).element_size()
    assert c % vec == 0 and (c * size) % (vec * size) == 0
    assert vec * size in (16, 8, 4, 2) or vec == 1


def test_align_vector_width_rejects_other_dtypes():
    with pytest.raises(ValueError, match="f32 or bf16"):
        _cuda.align_vector_width(256, torch.float16)


def test_check_aligned():
    """The alignment check the kernels' wrappers make: a view one element
    into a buffer raises, the buffer itself does not."""
    buf = torch.zeros(65, dtype=torch.bfloat16)
    _cuda.check_aligned(buf, "buf")
    with pytest.raises(ValueError, match="16-byte aligned"):
        _cuda.check_aligned(buf[1:], "view")


def _c_letter(param: str) -> str:
    """A C parameter's letter in ``_cuda.ENTRIES``: ``p`` for any pointer,
    else its type's."""
    ctype = param.rsplit(None, 1)[0] if "*" not in param else "*"
    return {"*": "p", "int": "i", "long long": "l", "float": "f"}[ctype]


def test_entries_match_the_csrc_prototypes():
    """``_cuda.ENTRIES`` is every ``extern "C"`` function of ``csrc/*.cu``,
    each under its own source with one letter a parameter of its
    prototype, and each returns an int."""
    found = {}
    for path in sorted(_cuda.SRC_DIR.glob("*.cu")):
        src = path.read_text()
        for ret, name, params in re.findall(
                r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', src):
            assert ret == "int", name
            letters = "".join(_c_letter(" ".join(p.split()))
                              for p in params.split(","))
            found[name] = (path.stem, letters)
    assert found == _cuda.ENTRIES
