"""PyTorch port, ``utils/checkpoint.py``: a save/restore round trip is
bitwise (parameters, batch-norm statistics, AdamW moments, the gradients of
a running accumulation cycle, ``step`` and ``updates``); ``params_only``
restores the weights and statistics only; a missing checkpoint gives
``None``; a ``wait=False`` save writes the state as it was when saved, once
``wait_for_saves`` returns.  On the single-scale model at 64x64 on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_step)
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt

CFG = Config(input_size=(64, 64), num_classes=3, batch_size=2, max_gt_boxes=4,
             n_train_pre_nms=128, n_train_post_nms=32, n_test_pre_nms=64,
             n_test_post_nms=16, roi_n_sample=8, rpn_n_sample=32,
             max_detections=8, grad_accum_steps=2, compute_dtype="float32",
             device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng):
    side = rng.uniform(12.0, 40.0, size=(2, 4, 2))
    xy = rng.rand(2, 4, 2) * (64 - side)
    valid = np.arange(4)[None] < np.array([[2], [3]])
    boxes = np.concatenate([xy, xy + side], -1).astype(np.float32)
    boxes[~valid] = 0.0
    return {"image": rng.rand(2, 64, 64, 3).astype(np.float32),
            "boxes": boxes, "labels": rng.randint(0, 3, (2, 4)).astype(np.int32),
            "valid": valid}


@pytest.fixture(scope="module")
def trained():
    """A state three micro-steps in: one update made, a cycle half summed."""
    _, state = create_train_state(CFG, seed=0, steps_per_epoch=4)
    rng = np.random.RandomState(0)
    for _ in range(3):
        state, _ = train_step(state, _batch(rng),
                              torch.Generator().manual_seed(1))
    assert state.step == 3 and state.updates == 1
    return state


def _state_tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"grad/{n}": p.grad for n, p in state.model.named_parameters()
                if p.grad is not None})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in s.items()})
    return out


def _assert_bitwise(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert (a.step, a.updates) == (b.step, b.updates)


def test_round_trip_is_bitwise(trained, tmp_path):
    full = ckpt.save_checkpoint(str(tmp_path), trained, name=ckpt.LAST)
    assert full == os.path.join(str(tmp_path), ckpt.LAST)
    assert os.listdir(full) == [ckpt.STATE_FILE]     # no temporary left
    _, fresh = create_train_state(CFG, seed=7, steps_per_epoch=4)
    assert ckpt.restore_checkpoint(str(tmp_path), fresh, name=ckpt.LAST) is fresh
    _assert_bitwise(fresh, trained)
    n_moments = sum(k.endswith("exp_avg_sq") for k in _state_tensors(fresh))
    n_grads = sum(k.startswith("grad/") for k in _state_tensors(fresh))
    assert n_moments == n_grads == len(list(fresh.model.parameters()))
    # the restored run goes on as the original does
    rng = np.random.RandomState(9)
    batch = _batch(rng)
    for s in (trained, fresh):
        train_step(s, batch, torch.Generator().manual_seed(2))
    _assert_bitwise(fresh, trained)


def test_params_only_restores_weights_and_statistics(trained, tmp_path):
    ckpt.save_checkpoint(str(tmp_path), trained, name=ckpt.BEST)
    _, fresh = create_train_state(CFG, seed=7, steps_per_epoch=4)
    assert ckpt.restore_checkpoint(str(tmp_path), fresh, params_only=True)
    for k, v in trained.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.step == fresh.updates == 0
    assert fresh.optimizer.state_dict()["state"] == {}
    assert all(p.grad is None for p in fresh.model.parameters())


def test_missing_checkpoint_gives_none(tmp_path):
    _, state = create_train_state(CFG, seed=0)
    assert ckpt.restore_checkpoint(str(tmp_path), state) is None
    assert ckpt.restore_checkpoint(str(tmp_path / "absent"), state,
                                   name=ckpt.LAST) is None


def test_async_save_writes_the_snapshot(trained, tmp_path):
    """``wait=False`` returns with the state copied: changing the weights
    afterwards does not reach the file, which ``wait_for_saves`` (or a
    restore, which waits first) makes whole."""
    _, twin = create_train_state(CFG, seed=0, steps_per_epoch=4)
    ckpt.save_checkpoint(str(tmp_path), trained, name="snap")
    ckpt.restore_checkpoint(str(tmp_path), twin, name="snap")
    ckpt.save_checkpoint(str(tmp_path), twin, name=ckpt.LAST, wait=False)
    with torch.no_grad():
        for p in twin.model.parameters():
            p.add_(1.0)
    twin.step = 99
    ckpt.wait_for_saves()
    ckpt.wait_for_saves()                       # nothing in flight: a no-op
    assert os.listdir(os.path.join(str(tmp_path), ckpt.LAST)) == [
        ckpt.STATE_FILE]
    _, fresh = create_train_state(CFG, seed=5, steps_per_epoch=4)
    ckpt.restore_checkpoint(str(tmp_path), fresh, name=ckpt.LAST)
    _assert_bitwise(fresh, trained)
    # a second async save replaces the first; a restore waits for it
    ckpt.save_checkpoint(str(tmp_path), twin, name=ckpt.LAST, wait=False)
    ckpt.restore_checkpoint(str(tmp_path), fresh, name=ckpt.LAST)
    assert fresh.step == 99
    assert torch.equal(next(fresh.model.parameters()),
                       next(twin.model.parameters()))
