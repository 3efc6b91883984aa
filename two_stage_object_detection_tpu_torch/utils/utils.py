"""Misc utilities (the JAX package's ``utils/utils.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> int:
    """Seed python, numpy and torch's default generators; returns ``seed``.

    The train driver draws its sampling priorities from generators of its
    own, seeded per micro-step (``train.step_generator``), so a run does not
    depend on this global state."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def update_ema(current_value, ema_alpha, last_ema=None):
    """EMA step (reference ``utils/utils.py:13-16``)."""
    if last_ema is None:
        return current_value
    return ema_alpha * current_value + (1 - ema_alpha) * last_ema
