"""PyTorch port, the drivers on the CPU at 64x64: ``train()`` on a
synthetic COCO root writes ``_best``, ``_last`` and ``train_meta.json``; a
run preempted mid-epoch (and mid accumulation cycle) and then resumed ends
with the parameters, statistics and optimiser state of an uninterrupted run,
bit for bit; ``evaluate_checkpoint`` and ``main(["eval", ...])`` give the
four finite keys; ``Predictor.from_checkpoint`` serves what was saved;
``multi_inference`` writes PNGs; the CLI's
``_parse_override`` and ``--flagship`` preset equal the JAX package's; and
what is not ported raises and says so.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.__main__ import (
    _load_cfg as j_load_cfg, _parse_override as j_parse_override)
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu_torch.__main__ import (
    _load_cfg, _parse_override, _parser, main)
from two_stage_object_detection_tpu_torch.config import MASK_FIELDS, Config
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.evaluate import evaluate_checkpoint
from two_stage_object_detection_tpu_torch.nets.trainer import predict_step
from two_stage_object_detection_tpu_torch.serving import Predictor
from two_stage_object_detection_tpu_torch.train import train
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
from two_stage_object_detection_tpu_torch.utils.preemption import (
    PreemptionGuard)

TINY = dict(input_size=(64, 64), num_classes=3, batch_size=2, max_gt_boxes=4,
            n_train_pre_nms=128, n_train_post_nms=32, n_test_pre_nms=64,
            n_test_post_nms=16, roi_n_sample=8, rpn_n_sample=32,
            max_detections=8, grad_accum_steps=2, compute_dtype="float32",
            num_epochs=2, train_ratio=1.0, eval_ratio=1.0, num_workers=2)
CFG = Config(**TINY, device="cpu")


def _sets(cfg_kw):
    out = []
    for k, v in cfg_kw.items():
        v = ",".join(map(str, v)) if isinstance(v, tuple) else v
        out += ["--set", f"{k}={v}"]
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    generate_synthetic_coco(root, split="train2017", num_images=8,
                            num_classes=3, image_size=(64, 64), seed=0)
    generate_synthetic_coco(root, split="val2017", num_images=2,
                            num_classes=3, image_size=(64, 64), seed=1)
    return root


@pytest.fixture(scope="module")
def uninterrupted(data_root, tmp_path_factory):
    """Two epochs of four micro-steps, an eval after the first
    (``epoch % eval_period == 0``)."""
    weights = str(tmp_path_factory.mktemp("w"))
    state = train(False, CFG, data_root, weights, eval_period=2, seed=3)
    return weights, state


class _StopAt(PreemptionGuard):
    """Requests a stop at its ``n``-th poll, i.e. before micro-step
    ``n - 1`` of the run would be applied."""

    def __init__(self, n):
        super().__init__()
        self.n, self.polls = n, 0

    def should_stop(self, sync=None):
        self.polls += 1
        if self.polls == self.n:
            self.request()
        return super().should_stop(sync)


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in s.items()})
    return out


def test_train_writes_checkpoints_and_meta(uninterrupted):
    weights, state = uninterrupted
    for name in (ckpt.BEST, ckpt.LAST):
        assert os.listdir(os.path.join(weights, name)) == [ckpt.STATE_FILE]
    with open(os.path.join(weights, "train_meta.json")) as f:
        assert np.isfinite(json.load(f)["min_eval_loss"])
    assert state.step == 8 and state.updates == 4
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())


def test_preempted_then_resumed_run_equals_uninterrupted(data_root, tmp_path,
                                                         uninterrupted):
    """Stopped before micro-step 3 of epoch 0 (three applied: one update
    and half a cycle summed), then resumed: the final state equals the
    uninterrupted run's bit for bit, and so does ``min_eval_loss``."""
    weights = str(tmp_path)
    guard = _StopAt(4)
    stopped = train(False, CFG, data_root, weights, eval_period=2, seed=3,
                    guard=guard)
    assert guard.requested and stopped.step == 3 and stopped.updates == 1
    assert not os.path.exists(os.path.join(weights, ckpt.BEST))
    resumed = train(False, CFG, data_root, weights, eval_period=2, seed=3,
                    resume=True)
    want_dir, want = uninterrupted
    assert (resumed.step, resumed.updates) == (want.step, want.updates)
    got_t, want_t = _tensors(resumed), _tensors(want)
    assert set(got_t) == set(want_t)
    for k, v in want_t.items():
        assert torch.equal(got_t[k], v), k
    metas = []
    for d in (weights, want_dir):
        with open(os.path.join(d, "train_meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]


def test_pre_train_starts_from_best_with_a_fresh_optimiser(data_root,
                                                           uninterrupted,
                                                           tmp_path):
    weights, _ = uninterrupted
    import shutil
    shutil.copytree(weights, str(tmp_path / "w"))
    state = train(False, CFG.replace(num_epochs=1, train_ratio=0.5),
                  data_root, str(tmp_path / "w"), pre_train=True,
                  eval_period=5, seed=3)
    assert state.step == 2 and state.updates == 1


def test_evaluate_checkpoint_and_cli_eval(data_root, uninterrupted, capsys):
    weights, _ = uninterrupted
    keys = ("mAP50", "mAP95", "mAP50_95", "eval_loss")
    for use_predict in (False, True):
        sweep = evaluate_checkpoint(weights, CFG, data_root,
                                    use_predict=use_predict,
                                    coco_summary=use_predict)
        assert all(np.isfinite(sweep[k]) for k in keys)
        assert all(0.0 <= sweep[k] <= 1.0 for k in keys[:3])
        assert ("coco" in sweep) == use_predict
        assert use_predict or sweep["eval_loss"] > 0
    with pytest.raises(FileNotFoundError):
        evaluate_checkpoint(weights, CFG, data_root, name="absent")
    capsys.readouterr()
    assert main(["eval", *_sets(TINY), "--set", "device=cpu", "--weights",
                 weights, "--data-root", data_root, "--checkpoint", "last",
                 "--predict"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(keys) and all(np.isfinite(out[k]) for k in keys)


def test_cli_needs_a_gpu_without_device_cpu(data_root, uninterrupted):
    weights, _ = uninterrupted
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["eval", *_sets(TINY), "--weights", weights, "--data-root",
              data_root])


def test_predictor_from_checkpoint_serves_the_saved_state(data_root,
                                                         uninterrupted,
                                                         tmp_path):
    """A ``Predictor`` from a saved ``_best`` answers as ``predict_step`` of
    the state that was saved, bit for bit; no checkpoint raises."""
    _, state = uninterrupted
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path), CFG)
    ckpt.save_checkpoint(str(tmp_path), state, name=ckpt.BEST)
    pred = Predictor.from_checkpoint(str(tmp_path), CFG, batch_sizes=(2,))
    images = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    got = pred(images)
    want = [t.cpu().numpy() for t in predict_step(state, images)]
    assert got["valid"].any()
    for field, w in zip(("boxes", "scores", "labels", "valid"), want):
        np.testing.assert_array_equal(got[field], w, err_msg=field)


def test_multi_inference_writes_pngs(data_root, uninterrupted, tmp_path):
    pytest.importorskip("matplotlib")
    from two_stage_object_detection_tpu_torch.infer import multi_inference
    weights, _ = uninterrupted
    paths = multi_inference(2, CFG, data_root, weights,
                            output_dir=str(tmp_path / "out"))
    assert len(paths) == 2
    assert all(os.path.getsize(p) > 0 and p.endswith(".png") for p in paths)


OVERRIDES = ["batch_size=4", "weight_decay=0.01", "backbone=resnet34",
             "remat_backbone=true", "remat_backbone=0", "fused_accum=on",
             "anchor_ratios=0.5,1,2", "input_size=(256,320)",
             "loc_normalize_std=0.1,0.1,0.2,0.2", "roi_bwd=pallas",
             "lr=3e-4", "num_epochs=7", "compute_dtype=float32"]


@pytest.mark.parametrize("kv", OVERRIDES)
def test_parse_override_equals_jax(kv):
    assert _parse_override(Config(), kv) == j_parse_override(JConfig(), kv)


@pytest.mark.parametrize("kv", ["not_a_field=1", "novalue",
                                "remat_backbone=maybe"])
def test_parse_override_rejects_as_jax(kv):
    for fn, cfg in ((_parse_override, Config()), (j_parse_override, JConfig())):
        with pytest.raises(SystemExit):
            fn(cfg, kv)


@pytest.mark.parametrize("sets", [None, ["backbone=resnet34", "lr=0.01"]])
def test_flagship_preset_equals_jax(sets):
    """Every field but ``device`` (the port's is chosen by its caller, the
    JAX package's comes from ``configs/config.json``)."""
    got = _load_cfg(argparse.Namespace(config=None, set=sets, flagship=True))
    want = j_load_cfg(argparse.Namespace(config=None, set=sets, flagship=True,
                                         compile_cache=None))
    assert got.fpn and got.loc_normalize and not got.mask_head
    for f in dataclasses.fields(Config):
        if f.name != "device" and f.name not in MASK_FIELDS:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_one_set_takes_several_pairs():
    """``--set a=1 b=2`` is ``--set a=1 --set b=2`` (the resident loop's
    command line in README.md)."""
    pairs = ["cache_device=true", "device_augment=true",
             "transfer_uint8=true", "fused_accum=true"]
    one = _parser().parse_args(["train", "--flagship", "--set", *pairs,
                                "--no-viz"])
    each = _parser().parse_args(
        ["train", "--flagship", *[a for kv in pairs for a in ("--set", kv)]])
    assert one.set == each.set == pairs and one.no_viz
    cfg = _load_cfg(one)
    assert cfg == _load_cfg(each)
    assert (cfg.fpn and cfg.cache_device and cfg.device_augment
            and cfg.transfer_uint8 and cfg.fused_accum)


def test_unported_options_raise(data_root, tmp_path):
    """``spatial`` (image rows over the mesh's model axis) is ported: in one
    process ``train(spatial=True)`` trains on one device (no model axis,
    as the JAX package's ``train`` without a mesh), and
    ``shard_batch_spatial`` refuses a mesh within one process (it places a
    rank's rows; over ranks: ``tests/test_torch_spatial_train.py``); a
    mesh that is not a ``parallel.mesh.Mesh`` is refused.  (The data and
    model axes are ported: ``tests/test_torch_parallel*.py``, and a mesh
    with a model axis builds here;
    ``cache_device`` and ``device_augment`` too:
    ``tests/test_torch_device_cache.py``; the ``serve`` and ``export``
    commands too: ``tests/test_torch_serving_http.py``,
    ``tests/test_torch_export.py``.  Without a checkpoint each says which
    directory has none.)"""
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch_spatial)
    state = train(False, CFG.replace(num_epochs=1), data_root,
                  str(tmp_path), eval_period=2, spatial=True)
    assert state.model.spatial is None and state.step > 0
    mesh = make_mesh(n_model=2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="over processes"):
        shard_batch_spatial({}, mesh)
    with pytest.raises(TypeError, match="Mesh"):
        train(False, CFG, data_root, str(tmp_path), mesh=object())
    missing = str(tmp_path / "no_weights")
    with pytest.raises(FileNotFoundError, match="no_weights"):
        main(["serve", "--weights", missing, "--set", "device=cpu"])
    with pytest.raises(SystemExit, match="no_weights"):
        main(["export", "--weights", missing, "--set", "device=cpu"])
