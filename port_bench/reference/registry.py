"""Backbone registry: name -> (feature extractor module, output channels)."""

from __future__ import annotations

import torch

from .hardnet import (
    HarDNetFeatureExtraction)
from .resnet import (
    ResNetFeatureExtraction)

_RESNETS = {
    "resnet10": dict(block="basic", blocks_num=(1, 1, 1, 1)),
    "resnet34": dict(block="basic", blocks_num=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", blocks_num=(3, 4, 23, 3)),
    "resnext50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3),
                      groups=32, width_per_group=4),
}


def build_backbone(name: str, dtype=torch.float32, remat: bool = False,
                   pyramid: bool = False):
    """Build a feature extractor by name, as the JAX package's registry does.

    ``hardnet39/68/85`` are the reference layout, ``hardnet39s/68s/85s`` the
    strided variants.  ``remat`` rematerialises HarDBlock activations in the
    backward pass (the resnets ignore it).  ``pyramid=True`` gives the FPN taps (C2..C5) and a
    per-tap channel tuple (resnets and the strided hardnets only);
    otherwise the stride-16 map (no resnet layer4).
    """
    name = name.lower()
    if name.startswith("hardnet"):
        spec = name.replace("hardnet", "")
        strided = spec.endswith("s")
        arch = int(spec.rstrip("s"))
        if pyramid and not strided:
            raise ValueError(
                f"backbone {name!r} cannot feed an FPN: the reference layout "
                f"keeps all blocks at one spatial size (stride-1 quirk) — "
                f"use hardnet{arch}s or a resnet backbone")
        mod = HarDNetFeatureExtraction(arch=arch, dtype=dtype, strided=strided,
                                       pyramid=pyramid, remat=remat)
        return mod, mod.out_channels
    if name not in _RESNETS:
        raise ValueError(f"unknown backbone {name!r}; expected hardnet39/68/85 "
                         f"or {sorted(_RESNETS)}")
    kw = dict(_RESNETS[name])
    if not pyramid:
        kw["blocks_num"] = kw["blocks_num"][:3]
    mod = ResNetFeatureExtraction(dtype=dtype, pyramid=pyramid, **kw)
    return mod, mod.out_channels
