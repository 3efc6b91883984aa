"""The request wire, unpacked by the reference itself.

Frozen from the port's ``serving.py`` (the u8 wire's division): the same
operations in the same order, on torch tensors, so that the reference
reads the raw bytes that were served and nothing the program made of
them.
"""

from __future__ import annotations

import torch

from .geometry import div_exact


def u8_to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` -> float32 in [0, 1]."""
    return div_exact(images.to(torch.float32), 255.0)
