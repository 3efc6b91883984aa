"""PyTorch port, ``torch.export`` of predict (``serving.export_program`` /
``load_exported``, the CLI's ``export``) and the custom ops that keep the
CUDA kernels in an exported graph.  On the CPU.

* Both models export (the flagship's FPN, on a ResNet-10 trunk to keep the
  artifact small, and the single-scale HarDNet-39 of ``Config()``, tiny),
  and the loaded programs equal eager predict bit for bit.  Two faults blocked this: RoIPool's plain loops took
  their trip count from the device (``ops/roi_pool.py``), and the FPN's
  span-aware levels read their scales back from a tensor (``nets/fpn.py``).
* The portable artifact round-trips against the JAX package's
  ``predict_step`` on the same weights, within the box tolerance.
* A constant first made while tracing is not cached (it is a fake tensor).
* Each custom op's fake implementation gives the shapes and dtypes of the
  plain version (the ops themselves run only on the card:
  ``tests/test_torch_kernels.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from tests.test_torch_serving import KW, assert_matches_jax, jax_model
from two_stage_object_detection_tpu.nets.trainer import (
    TrainState as JTrainState, predict_step)
from two_stage_object_detection_tpu_torch.__main__ import main
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state)
from two_stage_object_detection_tpu_torch.ops import geometry
from two_stage_object_detection_tpu_torch.ops.proposals import (
    fused_proposals_op, fused_proposals_rows_reference, greedy_nms_op,
    greedy_nms_rows_reference)
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    multilevel_roi_align, roi_pool_argmax)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    roi_pool_argmax_op, roi_pool_values_op)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    windowed_align_op)
from two_stage_object_detection_tpu_torch.serving import (
    export_program, load_exported)
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

# the flagship's FPN at 64x64 on a ResNet-10 trunk (a fifth of ResNet-50's
# weights to write and read back)
FPN = {**KW, "backbone": "resnet10"}
# the single scale of Config() at 64x64 through the CLI's --set
SINGLE_SETS = ["device=cpu", "input_size=64,64", "num_classes=3",
               "n_test_post_nms=16", "max_detections=8", "score_thresh=0.0",
               "compute_dtype=float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The flagship exported with ``export_program`` from JAX-carried
    weights: ``(eager model, loaded program, flax model, variables)``."""
    jm, v = jax_model(FPN)
    model = load_jax_variables(FasterRCNN(Config(**FPN, device="cpu")),
                               v["params"], v["batch_stats"])
    path = str(tmp_path_factory.mktemp("export") / "flagship.pt2")
    assert export_program(model.cfg, model, path, batch_size=2) \
        == os.path.getsize(path) > 0
    return model, load_exported(path), jm, v


@pytest.fixture(scope="module")
def single_scale(tmp_path_factory):
    """The single scale exported through the CLI from a port checkpoint:
    ``(eager model, loaded program)``."""
    d = tmp_path_factory.mktemp("export")
    cfg = Config(device="cpu", input_size=(64, 64), num_classes=3,
                 n_test_post_nms=16, max_detections=8, score_thresh=0.0,
                 compute_dtype="float32")
    model, state = create_train_state(cfg, seed=3)
    ckpt.save_checkpoint(str(d), state, name=ckpt.BEST)
    path = str(d / "single.pt2")
    assert main(["export", "--weights", str(d), "--out", path,
                 "--batch-size", "2", "--set", *SINGLE_SETS]) == 0
    return model, load_exported(path, device="cpu")


@pytest.mark.parametrize("name", ["flagship", "single_scale"])
def test_exported_program_equals_eager_predict(request, rng, name):
    """The loaded program's four outputs equal eager predict bit for bit."""
    model, run = request.getfixturevalue(name)[:2]
    x = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    got = run(x)
    want = model.predict(x)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[3].any()), "no detections to compare"


def test_portable_program_matches_jax_predict_step(flagship, rng):
    """The flagship's portable artifact against the JAX package's
    ``predict_step`` on the same weights and images."""
    _, run, jm, v = flagship
    state = JTrainState.create(apply_fn=jm.apply, params=v["params"],
                               batch_stats=v["batch_stats"],
                               tx=optax.identity())
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = predict_step(state, jnp.asarray(x))
    got = [t.numpy() for t in run(torch.from_numpy(x))]
    assert_matches_jax(got, [np.asarray(a) for a in want])


def test_cli_export_refuses_a_missing_checkpoint(tmp_path):
    """Without a checkpoint ``export`` exits naming the directory (the
    ``single_scale`` fixture's ``export`` wrote an artifact)."""
    with pytest.raises(SystemExit, match="nope"):
        main(["export", "--weights", str(tmp_path / "nope"), "--out",
              str(tmp_path / "x.pt2"), "--set", *SINGLE_SETS])


def test_tracing_leaves_no_fake_constant():
    """``device_constant`` called first under ``torch.export`` returns a
    fake tensor and caches nothing; the cache keeps only real tensors."""
    saved = dict(geometry._CONSTANTS)
    geometry._CONSTANTS.clear()
    try:
        class Scale(torch.nn.Module):
            def forward(self, x):
                return x * geometry.device_constant([0.5, 2.0], torch.float32,
                                                    x.device)

        ep = torch.export.export(Scale(), (torch.ones(2),), strict=False)
        assert not geometry._CONSTANTS
        assert torch.equal(ep.module()(torch.ones(2)), torch.tensor([0.5, 2.0]))
        c = geometry.device_constant([0.5, 2.0], torch.float32, "cpu")
        assert not isinstance(c, FakeTensor) and len(geometry._CONSTANTS) == 1
    finally:
        geometry._CONSTANTS.clear()
        geometry._CONSTANTS.update(saved)


def _meta(t):
    return t.to("meta")


def _like(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(g.shape, g.dtype) for g in got] == \
        [(w.shape, w.dtype) for w in want]


def test_fake_implementations_match_the_plain_versions(rng):
    """On meta tensors each custom op runs its fake implementation: the
    shapes and dtypes of the plain version on the same inputs."""
    xy = rng.rand(2, 50, 2).astype(np.float32) * 40
    boxes = torch.from_numpy(np.concatenate([xy, xy + 8], -1))
    scores = torch.from_numpy(rng.rand(2, 50).astype(np.float32))
    _like(greedy_nms_op(_meta(boxes), _meta(scores), 7, 0.7),
          greedy_nms_rows_reference(boxes, scores, n_post=7,
                                    iou_threshold=0.7))

    locs = torch.from_numpy(rng.randn(2, 50, 4).astype(np.float32) * 0.1)
    _like(fused_proposals_op(_meta(locs), _meta(scores), _meta(boxes[0]),
                             64.0, 64.0, 0.7, 9, 4.0),
          fused_proposals_rows_reference(locs, scores, boxes[0], (64, 64),
                                         nms_iou=0.7, n_post_nms=9,
                                         min_size=4.0))

    hw = [(16, 16), (8, 8)]
    pyr = [torch.randn(2, h, w, 8) for h, w in hw]
    levels = torch.zeros((2, 50), dtype=torch.int32)
    _like(windowed_align_op([_meta(p) for p in pyr], _meta(boxes),
                            _meta(levels), [0.25, 0.25, 0.125, 0.125], 7, 2,
                            8, False),
          multilevel_roi_align(tuple(pyr), boxes, levels,
                               ((0.25, 0.25), (0.125, 0.125)), 7, 2, 8))

    feats = torch.randn(2, 8, 8, 4, dtype=torch.bfloat16)
    pooled, argmax = roi_pool_argmax(feats, boxes, 7, 0.125)
    _like(roi_pool_values_op(_meta(feats), _meta(boxes), 7, 0.125), pooled)
    _like(roi_pool_argmax_op(_meta(feats), _meta(boxes), 7, 0.125),
          (pooled, argmax))
