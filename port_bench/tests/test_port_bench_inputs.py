"""The generator repeats from the seed, and seeds move order, not amount."""

import numpy as np
import pytest
import torch

from port_bench import inputs

BIG = 2 ** 31 + 12345


def test_images_repeat_from_the_seed():
    a = inputs.images_u8(3, 32, 48, inputs.device_generator(BIG, "cpu", 4))
    b = inputs.images_u8(3, 32, 48, inputs.device_generator(BIG, "cpu", 4))
    c = inputs.images_u8(3, 32, 48, inputs.device_generator(BIG + 1, "cpu", 4))
    assert a.dtype == torch.uint8 and a.shape == (3, 32, 48, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ground_truth_repeats_and_has_coco_shape():
    spec = {"mean_instances": 7.7, "area_shares": [0.41, 0.34, 0.24],
            "side_px": [[4.0, 32.0], [32.0, 96.0], [96.0, 560.0]],
            "aspect": [0.5, 2.0]}
    b1 = inputs.gt_boxes(4000, spec, 600, 600, 80, 100, BIG)
    b2 = inputs.gt_boxes(4000, spec, 600, 600, 80, 100, BIG)
    for x, y in zip(b1, b2):
        assert np.array_equal(x, y)
    boxes, labels, valid = b1
    counts = valid.sum(1)
    assert counts.min() >= 1 and counts.max() <= 100
    assert 7.0 < counts.mean() < 8.4 and counts.max() > 30
    v = boxes[valid]
    assert (v[:, 0] >= 0).all() and (v[:, 2] <= 600).all()
    assert (v[:, 3] <= 600).all() and (v[:, 2] > v[:, 0]).all()
    area = (v[:, 2] - v[:, 0]) * (v[:, 3] - v[:, 1])
    small, large = (area < 32 ** 2).mean(), (area > 96 ** 2).mean()
    assert 0.35 < small < 0.5 and 0.18 < large < 0.3
    assert labels[valid].max() < 80


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_sub_seeds_take_large_seeds(seed):
    s = inputs.sub_seed(seed, 3)
    assert 0 <= s < 2 ** 63 and s == inputs.sub_seed(seed, 3)
    assert s != inputs.sub_seed(seed, 4)
