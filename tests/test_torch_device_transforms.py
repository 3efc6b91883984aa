"""PyTorch port, the augmentation on the card
(``data/device_transforms.py``) against the JAX package's, in float32 on
the CPU.

The two packages draw from different generators, so they are held against
each other on the draws: the test reproduces the JAX package's key tree
(``split(key, B)`` per image, ``split(k, 3)`` for photometric / flip /
jitter, ``split(k1, 10)`` for the photometric draws, ``bernoulli(0.5)`` and
``uniform`` as in its ``_photometric``, ``randint(k3, (), 0, 5)``) and feeds
those values to the port's ``apply_augment``, beside JAX's
``augment_batch`` on the same key.

Tolerances: the jitter matrices within 1e-6 at n = 64 and 1e-4 at n = 600
(measured 1.2e-7 and 1.8e-7); augmented images within 1e-5 (f32 sums of up
to 64 products in another order), boxes exactly.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train import MODELS, _batch
from two_stage_object_detection_tpu.data import device_transforms as jdt
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.device_transforms import (
    COINS, SCALES, _jitter_matrices, apply_augment, augment_batch,
    draw_augment)
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_step)

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(key, b):
    """The JAX package's draws for a batch of ``b`` under ``key``, as a
    record of the port's ``draw_augment``."""
    coins, uniforms, flip, jitter = [], [], [], []
    for k in jax.random.split(key, b):
        k1, k2, k3 = jax.random.split(k, 3)
        ks = jax.random.split(k1, 10)
        coins.append([bool(jax.random.bernoulli(ks[i], 0.5))
                      for i in (0, 2, 3, 6, 8, 9)])
        uniforms.append([float(jax.random.uniform(ks[i], (), minval=lo,
                                                  maxval=hi))
                         for i, lo, hi in ((1, 0.875, 1.125), (4, 0.5, 1.5),
                                           (5, 0.5, 1.5), (7, -0.05, 0.05))])
        flip.append(bool(jax.random.bernoulli(k2, 0.5)))
        jitter.append(int(jax.random.randint(k3, (), 0, len(SCALES))))
    return {"coins": torch.tensor(coins), "uniforms": torch.tensor(uniforms),
            "flip": torch.tensor(flip), "jitter": torch.tensor(jitter)}


def _images_and_boxes(rng, b=3, size=64, g=4):
    images = rng.rand(b, size, size, 3).astype(np.float32)
    xy = rng.rand(b, g, 2) * size * 0.6
    boxes = np.concatenate([xy, xy + rng.rand(b, g, 2) * size * 0.3 + 2], -1)
    boxes[:, -1] = 0.0                                  # a padding row
    return images, boxes.astype(np.float32)


@pytest.mark.parametrize("n, tol", [(64, 1e-6), (600, 1e-4)])
def test_jitter_matrices_match_jax(n, tol):
    """``M_s = R(m->n) @ R(n->m)`` for each scale, the identity at 1.0."""
    want = np.asarray(jdt._jitter_matrices(n, SCALES))
    got = _jitter_matrices(n, SCALES, "cpu")
    assert got.shape == (len(SCALES), n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert torch.equal(got[SCALES.index(1.0)], torch.eye(n))
    assert _jitter_matrices(n, SCALES, "cpu") is got        # built once


@pytest.mark.parametrize("scale_jitter", [True, False])
def test_apply_augment_on_jax_draws_matches_jax(scale_jitter):
    """Four keys, B=3 at 64x64: the port's ``apply_augment`` on the JAX
    draws equals the JAX ``augment_batch`` on that key; over the keys
    every coin falls both ways."""
    rng = np.random.RandomState(0)
    seen = []
    for seed in range(4):
        images, boxes = _images_and_boxes(rng)
        key = jax.random.PRNGKey(seed)
        wi, wb = jdt.augment_batch(images, boxes, key,
                                   scale_jitter=scale_jitter)
        draws = jax_draws(key, 3)
        gi, gb = apply_augment(T(images), T(boxes), draws, scale_jitter)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0,
                                   atol=1e-5, err_msg=f"key {seed}")
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        seen.append(torch.cat([draws["coins"], draws["flip"][:, None]], 1))
    seen = torch.cat(seen)
    assert seen.any(0).all() and (~seen).any(0).all(), (COINS, seen)


def test_flip_boxes_and_range_before_the_jitter():
    """The flip writes ``w - x2, y1, w - x1, y2`` on every row, padding rows
    too, and mirrors the image; unflipped images and boxes pass unchanged;
    the photometric result is clipped to [0, 1] before the flip."""
    rng = np.random.RandomState(1)
    images, boxes = _images_and_boxes(rng, b=2)
    images[0, :8] = 0.99                     # brightened past 1, clipped
    off = {"coins": torch.zeros(2, 6, dtype=torch.bool),
           "uniforms": torch.tensor([[1.0, 1.0, 1.0, 0.0]] * 2),
           "flip": torch.tensor([True, False]),
           "jitter": torch.zeros(2, dtype=torch.int64)}
    gi, gb = apply_augment(T(images), T(boxes), off, scale_jitter=False)
    w = 64
    want = np.stack([w - boxes[0, :, 2], boxes[0, :, 1], w - boxes[0, :, 0],
                     boxes[0, :, 3]], -1)
    np.testing.assert_array_equal(gb[0].numpy(), want)
    assert (gb[0, -1].numpy() == [w, 0, w, 0]).all()       # padding row
    np.testing.assert_array_equal(gb[1].numpy(), boxes[1])
    np.testing.assert_array_equal(gi[0].numpy(), images[0, :, ::-1])
    np.testing.assert_array_equal(gi[1].numpy(), images[1])
    bright = dict(off, coins=torch.tensor([[True] + [False] * 5] * 2),
                  uniforms=torch.tensor([[1.125, 1.0, 1.0, 0.0]] * 2))
    gi, _ = apply_augment(T(images), T(boxes), bright, scale_jitter=False)
    assert float(gi.max()) == 1.0 and float(gi.min()) >= 0.0
    assert (gi[0, :8] == 1.0).all()


def test_augment_batch_is_determined_by_its_generator():
    """One seed, the same draws and outputs; another seed, other draws.
    ``scale_jitter=False`` draws index 0 for every image."""
    rng = np.random.RandomState(2)
    images, boxes = (T(a) for a in _images_and_boxes(rng, b=4))
    run = lambda s, j=True: augment_batch(
        images, boxes, torch.Generator().manual_seed(s), scale_jitter=j)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    draws = draw_augment(64, torch.Generator().manual_seed(3))
    assert draws["jitter"].min() >= 0 and draws["jitter"].max() == 4
    assert 0.875 <= float(draws["uniforms"][:, 0].min())
    assert float(draws["uniforms"][:, 3].abs().max()) <= 0.05
    no_jit = draw_augment(8, torch.Generator().manual_seed(3), False)
    assert (no_jit["jitter"] == 0).all()


def test_train_step_with_device_augment_runs_and_repeats():
    """``train_step(device_augment=True)`` on u8 images: finite losses; two
    runs from the same seed and generator seed end equal; the augmented
    step differs from the plain one."""
    cfg = Config(**MODELS["single_scale"], device="cpu")
    batch = _batch(np.random.RandomState(5))
    batch["image"] = np.round(batch["image"] * 255).astype(np.uint8)

    def run(aug):
        model, state = create_train_state(cfg, seed=3)
        gen = torch.Generator().manual_seed(11)
        for _ in range(2):
            state, losses = train_step(state, batch, gen, device_augment=aug)
            assert np.isfinite(float(losses["total"]))
        return state.updates, [p.detach().clone() for p in model.parameters()]

    (ua, a), (_, b), (_, plain) = run(True), run(True), run(False)
    assert ua == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(x, y) for x, y in zip(a, plain))
