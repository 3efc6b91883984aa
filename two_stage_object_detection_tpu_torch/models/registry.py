"""Backbone registry: name -> (feature extractor module, output channels)."""

from __future__ import annotations

import torch

from two_stage_object_detection_tpu_torch.models.resnet import (
    ResNetFeatureExtraction)

_RESNETS = {
    "resnet10": dict(block="basic", blocks_num=(1, 1, 1, 1)),
    "resnet34": dict(block="basic", blocks_num=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", blocks_num=(3, 4, 23, 3)),
    "resnext50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3),
                      groups=32, width_per_group=4),
}


def build_backbone(name: str, dtype=torch.float32, pyramid: bool = False):
    """Build a feature extractor by name, as the JAX package's registry does.

    ``pyramid=True`` gives the FPN taps (C2..C5) and a per-tap channel
    tuple; otherwise the stride-16 trunk (no layer4).  HarDNet is not
    ported yet.
    """
    name = name.lower()
    if name.startswith("hardnet"):
        raise NotImplementedError(
            f"backbone {name!r}: HarDNet is not ported to PyTorch yet "
            "(ROADMAP.md, 'Modules to port', the single-scale/HarDNet path)")
    if name not in _RESNETS:
        raise ValueError(f"unknown backbone {name!r}; expected hardnet39/68/85 "
                         f"or {sorted(_RESNETS)}")
    kw = dict(_RESNETS[name])
    if not pyramid:
        kw["blocks_num"] = kw["blocks_num"][:3]
    mod = ResNetFeatureExtraction(dtype=dtype, pyramid=pyramid, **kw)
    return mod, mod.out_channels
