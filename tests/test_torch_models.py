"""PyTorch port, modules: ResNet taps, FPN neck and heads, level assignment
and the flax weight map, against the JAX package's flax modules in float32
on the CPU.

Weights come from flax init and are carried across by
``load_jax_variables``; batch-norm statistics, batch-norm affine terms and
PReLU slopes are randomised first, so every rule of the map is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.models.resnet import (
    ResNetFeatureExtraction as JResNet)
from two_stage_object_detection_tpu.nets import fpn as jfpn
from two_stage_object_detection_tpu_torch.models.registry import build_backbone
from two_stage_object_detection_tpu_torch.models.resnet import Bottleneck
from two_stage_object_detection_tpu_torch.nets import fpn as tfpn
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

T = torch.from_numpy
_RESNETS = {
    "resnet10": dict(block="basic", blocks_num=(1, 1, 1, 1)),
    "resnet50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), unfreeze(tree))


def _randomise(tree, rng):
    """Perturb BN scale/bias/mean/var and PReLU alpha leaves in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomise(v, rng)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k == "alpha":
            tree[k] = np.float32(rng.uniform(0.05, 0.5))
    return tree


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# -------------------------------------------------------------- backbone
@pytest.mark.parametrize("name", ["resnet10", "resnet50"])
def test_resnet_taps_match_flax(rng, name):
    """C2..C5 of the port == flax eval mode with randomised BN statistics
    and PReLU slopes: <= 1e-4 relative to each tap's peak (float32 conv
    accumulation order through up to 50 layers)."""
    jmod = JResNet(pyramid=True, **_RESNETS[name])
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    v = jax.jit(jmod.init)(jax.random.PRNGKey(1), x)
    params = _randomise(_np_tree(v["params"]), rng)
    stats = _randomise(_np_tree(v["batch_stats"]), rng)
    want = jax.jit(jmod.apply)({"params": params, "batch_stats": stats}, x)
    tmod, chans = build_backbone(name, pyramid=True)
    load_jax_variables(tmod, params, stats)
    with torch.no_grad():
        got = tmod(T(x).permute(0, 3, 1, 2))
    assert chans == jmod.out_channels and len(got) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_one_prelu_per_block_and_grouped_conv():
    """Each block has ONE PReLU (shared slope), and resnext50's 3x3 convs
    are grouped 32 ways, as in flax."""
    mod, _ = build_backbone("resnext50", pyramid=True)
    blk = mod.layer1_0
    assert isinstance(blk, Bottleneck)
    assert sum(1 for n, _ in blk.named_children() if "relu" in n) == 1
    assert blk.conv2.groups == 32 and tuple(blk.conv2.weight.shape) == (128, 4, 3, 3)
    # HarDNet is ported (tests/test_torch_hardnet.py); what the registry
    # refuses is a reference-layout HarDNet under an FPN, and unknown names
    with pytest.raises(ValueError, match="cannot feed an FPN"):
        build_backbone("hardnet39", pyramid=True)
    with pytest.raises(ValueError, match="unknown backbone"):
        build_backbone("vgg16")


def test_weight_map_rejects_unknown_missing_and_misshapen(rng):
    jmod = JResNet(pyramid=True, **_RESNETS["resnet10"])
    v = jax.jit(jmod.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                            np.float32))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    tmod, _ = build_backbone("resnet10", pyramid=True)
    extra = _np_tree(v["params"])
    extra["conv1"]["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="bogus"):
        load_jax_variables(tmod, extra, stats)
    bad = _np_tree(v["params"])
    bad["conv1"]["kernel"] = bad["conv1"]["kernel"][:, :, :, :8]
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tmod, bad, stats)
    with pytest.raises(KeyError, match="no flax counterpart"):
        load_jax_variables(tmod, params, {})


# ------------------------------------------------------------------- FPN
def _taps(rng, b=2, chans=(8, 16, 32, 64), sizes=(16, 8, 4, 2)):
    return [rng.randn(b, s, s, c).astype(np.float32)
            for c, s in zip(chans, sizes)]


def test_fpn_neck_and_rpn_head_match_flax(rng):
    """P2..P6 and the RPN outputs flattened in NHWC anchor order, with
    ceil-halving sizes (15 -> 8 -> 4 -> 2) that need the upsample crop:
    <= 1e-5."""
    taps = _taps(rng, sizes=(15, 8, 4, 2))
    jneck = jfpn.FPNNeck(channels=16)
    vn = jneck.init(jax.random.PRNGKey(0), taps)
    want = jneck.apply(vn, taps)
    tneck = tfpn.FPNNeck((8, 16, 32, 64), 16)
    load_jax_variables(tneck, _np_tree(vn["params"]))
    with torch.no_grad():
        got = tneck([T(t).permute(0, 3, 1, 2) for t in taps])
    assert len(got) == 5 and got[-1].shape[2:] == (1, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-5)

    jhead = jfpn.FPNRPNHead(n_anchors=3, channels=16)
    vh = jhead.init(jax.random.PRNGKey(1), want)
    wl, ws = jhead.apply(vh, want)
    thead = tfpn.FPNRPNHead(3, 16)
    load_jax_variables(thead, _np_tree(vh["params"]))
    with torch.no_grad():
        gl, gs = thead(got)
    assert gl.shape == (2, (15 * 15 + 8 * 8 + 4 * 4 + 2 * 2 + 1) * 3, 4)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)


def test_levels_match_flax(rng):
    """Eq.-1 levels (rois exactly at the 112/224/448 px size boundaries
    included) and span-aware bumps equal JAX's."""
    sides = np.array([16, 111.9, 112, 224, 448, 896, 1000], np.float32)
    edge = np.stack([np.zeros_like(sides)] * 2 + [sides] * 2, -1)
    x1 = rng.rand(40) * 300
    y1 = rng.rand(40) * 300
    w = rng.choice([20.0, 60.0, 150.0, 400.0], 40) * rng.uniform(0.3, 4.0, 40)
    h = rng.choice([20.0, 60.0, 150.0, 400.0], 40) * rng.uniform(0.3, 4.0, 40)
    rand = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    rois = np.concatenate([edge, rand])
    want = np.asarray(jfpn.fpn_level_assign(rois, 2, 5))
    got = tfpn.fpn_level_assign(T(rois), 2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    scales = tuple((s / 600.0, s / 600.0) for s in (150, 75, 38, 19))
    want_sa = jfpn.span_aware_levels(rois, want - 2, scales, 30.0)
    got_sa = tfpn.span_aware_levels(T(rois), got - 2, scales, 30.0)
    np.testing.assert_array_equal(got_sa.numpy(), np.asarray(want_sa))
    assert (np.asarray(want_sa) > want - 2).any()     # bumps exercised


def test_fpn_roi_head_matches_flax(rng):
    """Windowed predict route: level assignment with span-aware bumps,
    windowed RoIAlign, fc1 over (p, q, c), fc2, cls_loc/score: <= 1e-4.
    The hybrid train route (``use_window=False``) has the same forward; the
    dense route (``window=0``) runs on the same weights (its parity with
    JAX: ``tests/test_torch_roi_routes.py``)."""
    c, img = 16, (64, 64)
    pyr = [rng.rand(2, s, s, c).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    x1 = rng.rand(2, 10, 2) * 40
    rois = np.concatenate([x1, x1 + rng.rand(2, 10, 2) * 40 + 4],
                          -1).astype(np.float32)
    jhead = jfpn.FPNRoIHead(n_class=4, fc_dim=32, pallas="off")
    v = jhead.init(jax.random.PRNGKey(0), pyr, rois, img)
    wl, ws = jhead.apply(v, pyr, rois, img)
    thead = tfpn.FPNRoIHead(4, channels=c, fc_dim=32)
    load_jax_variables(thead, _np_tree(v["params"]))
    with torch.no_grad():
        gl, gs = thead([T(p).permute(0, 3, 1, 2) for p in pyr], T(rois), img)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-4)
    with torch.no_grad():
        hl, hs = thead([T(p).permute(0, 3, 1, 2) for p in pyr], T(rois), img,
                       use_window=False)
    assert torch.equal(hl, gl) and torch.equal(hs, gs)
    dense = tfpn.FPNRoIHead(4, channels=c, fc_dim=32, window=0)
    load_jax_variables(dense, _np_tree(v["params"]))
    with torch.no_grad():
        dl, ds = dense([T(p).permute(0, 3, 1, 2) for p in pyr], T(rois), img)
    assert dl.shape == gl.shape and ds.shape == gs.shape
    assert bool(torch.isfinite(dl).all() and torch.isfinite(ds).all())


def test_global_avg_pool_classifier_matches_flax(rng):
    """``GlobalAvgPoolClassifier``: ``[N, P, P, C] -> [N, C]`` within 1e-6
    of the flax module."""
    from two_stage_object_detection_tpu.models.hardnet import (
        GlobalAvgPoolClassifier as JPool)
    from two_stage_object_detection_tpu_torch.models.hardnet import (
        GlobalAvgPoolClassifier)
    x = rng.randn(3, 7, 7, 16).astype(np.float32)
    want = np.asarray(JPool().apply({}, jnp.asarray(x)))
    got = GlobalAvgPoolClassifier()(T(x)).numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
