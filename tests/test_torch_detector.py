"""PyTorch port, the whole slice: FPN-ResNet50 ``predict`` against the JAX
package's ``FasterRCNN.predict`` with the same weights (JAX init carried
across by ``load_jax_variables``), and the ``Predictor`` serving surface.
float32 on the CPU, where the port runs the plain versions of its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.serving import FIELDS, Predictor

# truncated proposal route: 6 * 64 <= 1,023 anchors at 64x64
KW = dict(fpn=True, backbone="resnet50", loc_normalize=True, input_size=(64, 64),
          fpn_channels=32, fpn_fc_dim=64, num_classes=3, n_test_pre_nms=64,
          n_test_post_nms=16, max_detections=8, compute_dtype="float32",
          score_thresh=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    jm = JFasterRCNN(JConfig(**KW))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.array, unfreeze(v["params"]))
    stats = jax.tree.map(np.array, unfreeze(v["batch_stats"]))
    pred = Predictor.from_jax_variables(Config(**KW), params, stats,
                                        device="cpu", batch_sizes=(1, 2))
    return jm, v, pred


def test_predict_matches_jax(carried):
    """Equal ``valid`` and ``labels``; scores <= 1e-4 absolute; boxes
    within 1e-4 + 1e-4 * |box| px.  The boxes get a relative term: they
    decode RPN deltas that agree to ~5e-6 after 50 float32 conv layers
    accumulated in another order, and the decode scales that error by the
    anchor side (32..512 px) -- measured 3.4e-4 px on 64 px images."""
    jm, v, pred = carried
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="predict"))(v, x)
    got = pred.model.predict(torch.from_numpy(x))
    wb, ws, wl, wv = (np.asarray(a) for a in want)
    gb, gs, gl, gv = (t.numpy() for t in got)
    assert gv.sum() > 0, "no detections to compare"
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)
    assert gb.shape == (2, 8, 4) and gl.dtype == np.int32


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_predictor_buckets_match_direct_predict(carried, wire):
    """Buckets (1, 2) answer 1- and 3-image requests (3 = 1 + 2) with the
    arrays of a direct ``predict`` on those images: equal valid/labels,
    scores <= 1e-5, boxes <= 1e-5 + 1e-5 * |box| px (another batch size
    may pick another conv algorithm, and the decode scales delta noise by
    the anchor side, as in ``test_predict_matches_jax``)."""
    _, _, pred = carried
    server = Predictor(pred.cfg, pred.model, batch_sizes=(1, 2), wire=wire)
    assert sorted(server._plan(3)) == [1, 2]
    x = np.random.RandomState(4).rand(3, 64, 64, 3).astype(np.float32)
    if wire == "u8":
        req = np.round(x * 255).astype(np.uint8)
        x = req.astype(np.float32) / 255.0
    else:
        req = x
    for n in (1, 3):
        out = server(req[:n])
        direct = [t.numpy() for t in pred.model.predict(torch.from_numpy(x[:n]))]
        assert set(out) == set(FIELDS)
        for name, d in zip(FIELDS, direct):
            assert out[name].shape == d.shape
            if name in ("labels", "valid"):
                np.testing.assert_array_equal(out[name], d)
            else:
                np.testing.assert_allclose(out[name], d, atol=1e-5,
                                           rtol=1e-5 if name == "boxes" else 0)


def test_predictor_rejects_bad_requests(carried):
    _, _, pred = carried
    with pytest.raises(ValueError, match="uint8"):
        Predictor(pred.cfg, pred.model, wire="u8")(np.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="float"):
        pred(np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="static"):
        pred(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="wire"):
        Predictor(pred.cfg, pred.model, wire="u16")


def test_unported_routes_raise(carried):
    """A mesh that is not a ``parallel.mesh.Mesh`` is refused (the data
    axis is ported: ``tests/test_torch_parallel.py``).  The routes that
    raised before they were ported now build and predict: the single-scale
    ``align`` / ``mean`` RoI pooling and the dense FPN route
    (``fpn_roi_window=0``), whose parity with the JAX package is in
    ``tests/test_torch_roi_routes.py``, the yuv420 wire
    (``tests/test_torch_serving.py``), and serving with image rows over
    the mesh's model axis (``spatial``; ``tests/test_torch_spatial.py``),
    here over a ``(1, 2)`` mesh of CPU "devices"."""
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 64, 64, 3)
                         .astype(np.float32))
    for kw in ({"fpn": False, "backbone": "hardnet39", "roi_pool_mode": "align"},
               {"fpn": False, "backbone": "hardnet39", "roi_pool_mode": "mean"},
               {"fpn_roi_window": 0}):
        model = FasterRCNN(Config(**{**KW, **kw}), device="cpu")
        boxes, scores, labels, valid = model.predict(x)
        assert boxes.shape == (1, 8, 4) and valid.shape == (1, 8)
        assert bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
    _, _, pred = carried
    from two_stage_object_detection_tpu_torch.parallel.mesh import make_mesh
    rows = Predictor(pred.cfg, pred.model, batch_sizes=(1,), spatial=True,
                     mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))
    out = rows(x.numpy())
    assert rows.spatial and out["boxes"].shape == (1, 8, 4)
    assert np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()
    with pytest.raises(TypeError, match="Mesh"):
        Predictor(pred.cfg, pred.model, mesh=object())
    assert Predictor(pred.cfg, pred.model, wire="yuv420").wire == "yuv420"
