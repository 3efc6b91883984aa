"""PyTorch port, the dataset held on the device (``data/device_cache.py``)
and the loops over it, on the CPU at 64x64.

``DeviceDatasetCache`` needs a ``decode_only`` dataset and raises
``MemoryError`` above ``max_bytes`` (``build_loaders`` then falls back to
the streaming loaders); its batches equal the streaming ``decode_only``
batches bit for bit, and its index orders equal the JAX package's exactly.
``train_macro_step_resident`` equals K ``train_step`` calls on the gathered
batches and ``eval_scan_resident`` per-batch ``eval_step`` /
``predict_step``, bit for bit.  ``train()`` with ``cache_device`` and
``device_augment`` (the epoch loop over the cache) ends, bit for bit, where the
streaming ``decode_only`` + ``device_augment`` run ends, and so does a
resident run preempted and resumed, at an epoch boundary and inside an
accumulation cycle.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from test_torch_drivers import TINY, _StopAt, _tensors
from two_stage_object_detection_tpu.data.coco import load_coco as j_load_coco
from two_stage_object_detection_tpu.data.device_cache import (
    DeviceDatasetCache as JDeviceDatasetCache)
from two_stage_object_detection_tpu.data.pipeline import (
    DetectionDataset as JDetectionDataset)
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.coco import load_coco
from two_stage_object_detection_tpu_torch.data.device_cache import (
    DeviceDatasetCache)
from two_stage_object_detection_tpu_torch.data.pipeline import (
    DetectionDataset, Loader)
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, eval_scan_resident, eval_step,
    predict_step, train_macro_step, train_macro_step_resident, train_step)
from two_stage_object_detection_tpu_torch.train import build_loaders, train

# 4 images of batch 1 an epoch, accumulation cycles of 3 across epochs
CFG = Config(**{**TINY, "batch_size": 1, "grad_accum_steps": 3},
             device="cpu")
RESIDENT = CFG.replace(cache_device=True, device_augment=True,
                       transfer_uint8=True, fused_accum=True)
STREAMING = CFG.replace(device_augment=True, transfer_uint8=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    generate_synthetic_coco(root, split="train2017", num_images=4,
                            num_classes=3, image_size=(80, 72), seed=0)
    generate_synthetic_coco(root, split="val2017", num_images=2,
                            num_classes=3, image_size=(64, 64), seed=1)
    return root


def _dataset(root, split="train2017", u8=True, decode_only=True, jax=False):
    ann = os.path.join(root, "annotations", f"instances_{split}.json")
    if jax:
        return JDetectionDataset(j_load_coco(ann, os.path.join(root, split)),
                                 (64, 64), 4, decode_only=True,
                                 uint8_images=u8)
    return DetectionDataset(load_coco(ann, os.path.join(root, split)),
                            (64, 64), 4, decode_only=decode_only,
                            uint8_images=u8)


def test_cache_needs_decode_only_and_gates_its_bytes(data_root, caplog):
    """Not ``decode_only``: ``ValueError``; above ``max_bytes``:
    ``MemoryError``, and ``build_loaders`` warns and streams; without
    ``device_augment``, ``cache_device`` raises."""
    with pytest.raises(ValueError, match="decode_only"):
        DeviceDatasetCache(_dataset(data_root, decode_only=False), 2,
                           device="cpu")
    ds = _dataset(data_root)
    per_image = 64 * 64 * 3 + 4 * 16 + 4 * 4 + 4
    with pytest.raises(MemoryError, match="resident"):
        DeviceDatasetCache(ds, 2, max_bytes=4 * per_image - 1, device="cpu")
    cache = DeviceDatasetCache(ds, 2, max_bytes=4 * per_image, device="cpu")
    assert cache.nbytes == 4 * per_image and len(cache) == 2
    assert cache.data["image"].dtype == torch.uint8
    with caplog.at_level(logging.WARNING):
        tl, el, _ = build_loaders(RESIDENT.replace(cache_device_max_bytes=10),
                                  data_root)
    assert isinstance(tl, Loader) and isinstance(el, Loader)
    assert "falling back to streaming Loader" in caplog.text
    tl, el, _ = build_loaders(RESIDENT, data_root)
    assert isinstance(tl, DeviceDatasetCache) and tl.shuffle
    assert isinstance(el, DeviceDatasetCache) and not el.shuffle
    with pytest.raises(ValueError, match="requires device_augment"):
        build_loaders(CFG.replace(cache_device=True), data_root)


@pytest.mark.parametrize("u8", [True, False])
def test_cached_batches_equal_streaming_batches(data_root, u8):
    """Two shuffled epochs of batch 3 (4 images: one batch an epoch), bit
    for bit, in each wire's dtype."""
    ds = _dataset(data_root, u8=u8)
    cache = DeviceDatasetCache(ds, 3, device="cpu")
    loader = Loader(ds, 3, num_workers=2)
    try:
        for _ in range(2):
            got, want = list(cache), list(loader)
            assert len(got) == len(want) == 1
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == torch.from_numpy(w[k]).dtype, k
                    np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    finally:
        loader.close()
    assert cache.epoch == loader.epoch == 2


@pytest.mark.parametrize("batch", [1, 3, 6])
def test_index_orders_equal_jax(data_root, batch):
    """``epoch_indices`` over three epochs and ``all_indices`` equal the JAX
    ``DeviceDatasetCache``'s arrays exactly (batch 6 > 4 images tiles the
    order)."""
    mine = DeviceDatasetCache(_dataset(data_root), batch, seed=5,
                              device="cpu")
    theirs = JDeviceDatasetCache(_dataset(data_root, jax=True), batch,
                                 seed=5)
    for _ in range(3):
        a, b = mine.epoch_indices(), theirs.epoch_indices()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.all_indices(), theirs.all_indices())
    assert mine.epoch == theirs.epoch == 3


@pytest.fixture(scope="module")
def cache(data_root):
    return DeviceDatasetCache(_dataset(data_root), 2, device="cpu")


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("device_augment", [True, False])
def test_resident_macro_step_equals_single_steps(cache, device_augment):
    """One cycle of ``grad_accum_steps=2`` on batches 2 and 0 of an epoch:
    the resident macro step, the stacked macro step and two ``train_step``
    calls on the gathered batches end with the same parameters and losses,
    bit for bit."""
    cfg = CFG.replace(batch_size=2, grad_accum_steps=2)
    idx = np.array([[2, 3], [0, 1]])
    gens = lambda: [torch.Generator().manual_seed(s) for s in (7, 8)]
    batches = [{k: v[torch.from_numpy(i)] for k, v in cache.data.items()}
               for i in idx]
    results = []
    for route in ("resident", "stacked", "single"):
        model, state = create_train_state(cfg, seed=1)
        if route == "resident":
            state, totals = train_macro_step_resident(
                state, cache.data, idx, gens(), device_augment)
        elif route == "stacked":
            superbatch = {k: torch.stack([b[k] for b in batches])
                          for k in batches[0]}
            state, totals = train_macro_step(state, superbatch, gens(),
                                             device_augment)
        else:
            totals = torch.stack([
                train_step(state, b, g, device_augment)[1]["total"]
                for b, g in zip(batches, gens())])
        assert state.step == 2 and state.updates == 1 and totals.shape == (2,)
        results.append((totals, _params(model)))
    for totals, params in results[1:]:
        assert torch.equal(totals, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(params, results[0][1]))


@pytest.mark.parametrize("use_predict", [False, True])
def test_eval_scan_resident_equals_per_batch_steps(cache, use_predict):
    """Every output leaf of the resident pass, numpy on the host, equals
    the per-batch ``eval_step`` (train-graph protocol) or ``predict_step``
    outputs and the gathered ground truth, bit for bit; ``loss_total`` is
    the batch's total loss, or 0 under ``predict``."""
    _, state = create_train_state(CFG.replace(batch_size=2), seed=2)
    idx = cache.all_indices()
    outs = eval_scan_resident(state, cache.data, idx, use_predict=use_predict)
    assert all(isinstance(v, np.ndarray) for v in outs.values())
    assert outs["loss_total"].shape == (len(idx),)
    for bi, sel in enumerate(idx):
        b = {k: v[torch.from_numpy(sel)] for k, v in cache.data.items()}
        if use_predict:
            want = dict(zip(("boxes_pred", "classes_score_pred",
                             "classes_pred", "pred_valid"),
                            predict_step(state, b["image"])))
            want["loss_total"] = torch.zeros(())
        else:
            o = eval_step(state, b)
            want = {k: o[k] for k in ("boxes_pred", "classes_score_pred",
                                      "classes_pred", "pred_valid")}
            want["loss_total"] = o["losses"]["total"]
        want.update(gt_boxes=b["boxes"], gt_labels=b["labels"],
                    gt_valid=b["valid"])
        assert set(outs) == set(want)
        for k, w in want.items():
            assert outs[k][bi].dtype == w.numpy().dtype, k
            np.testing.assert_array_equal(outs[k][bi], w.numpy(), err_msg=k)
    assert outs["pred_valid"].any()


def _train(cfg, root, weights, **kw):
    return train(False, cfg, root, str(weights), eval_period=2, seed=3, **kw)


def _meta(weights):
    with open(os.path.join(str(weights), "train_meta.json")) as f:
        return json.load(f)


class _Loops(logging.Handler):
    """The ``loop`` attribute of every epoch record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.loops = []

    def emit(self, record):
        if hasattr(record, "loop"):
            self.loops.append(record.loop)


def _train_loops(cfg, root, weights, **kw):
    """``_train``, and the loop its epoch records name."""
    logger = logging.getLogger("two_stage_object_detection_tpu_torch")
    handler, level = _Loops(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return _train(cfg, root, weights, **kw), handler.loops
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@pytest.fixture(scope="module")
def resident_run(data_root, tmp_path_factory):
    weights = tmp_path_factory.mktemp("resident")
    state, loops = _train_loops(RESIDENT, data_root, weights)
    assert loops == ["resident", "resident"]
    return weights, state


def _assert_same_end(a, b):
    assert (a.step, a.updates) == (b.step, b.updates)
    got, want = _tensors(a), _tensors(b)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_resident_train_equals_streaming_train(data_root, tmp_path,
                                               resident_run):
    """Two epochs of four micro-steps (a cycle of three and one step of
    the next each), an eval after the first over the cached eval set:
    parameters, statistics, optimiser state and ``min_eval_loss`` equal
    the streaming run's; the epoch records name the loop that ran (the
    resident run's, ``resident``, in its fixture).  ``fused_accum`` changes
    nothing: the streaming run with it ends where the others end."""
    weights, resident = resident_run
    assert (resident.step, resident.updates) == (8, 2)
    streaming, loops = _train_loops(STREAMING, data_root, tmp_path)
    _assert_same_end(resident, streaming)
    assert _meta(weights) == _meta(tmp_path)
    assert loops == ["stream", "stream"]
    fused, loops = _train_loops(STREAMING.replace(fused_accum=True),
                                data_root, tmp_path / "fused")
    _assert_same_end(resident, fused)
    assert loops == ["stream", "stream"]


@pytest.mark.parametrize("first, stop_at, stopped_step", [
    (RESIDENT, 5, 4),      # resident, stopped at the start of epoch 1
    (STREAMING, 3, 2),     # streaming, stopped inside the first cycle
], ids=["resident", "streaming"])
def test_preempted_then_resumed_resident_run_equals_uninterrupted(
        data_root, tmp_path, resident_run, first, stop_at, stopped_step):
    """Stopped, then resumed on the resident loop: the final state and
    ``min_eval_loss`` equal the uninterrupted resident run's, bit for bit,
    whether the stop fell at an epoch boundary or inside an accumulation
    cycle (step 2 of a cycle of three: the resumed loop skips the two
    applied batches and finishes the cycle)."""
    guard = _StopAt(stop_at)
    stopped = _train(first, data_root, tmp_path, guard=guard)
    assert guard.requested and stopped.step == stopped_step
    resumed = _train(RESIDENT, data_root, tmp_path, resume=True)
    weights, want = resident_run
    _assert_same_end(resumed, want)
    assert _meta(tmp_path) == _meta(weights)
