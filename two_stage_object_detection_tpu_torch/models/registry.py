"""Backbone registry: name -> (feature extractor module, output channels)."""

from __future__ import annotations

import torch

from two_stage_object_detection_tpu_torch.models.hardnet import (
    HarDNetFeatureExtraction)
from two_stage_object_detection_tpu_torch.models.resnet import (
    ResNetFeatureExtraction)
from two_stage_object_detection_tpu_torch.models.swin import (
    SwinFeatureExtraction)

_RESNETS = {
    "resnet10": dict(block="basic", blocks_num=(1, 1, 1, 1)),
    "resnet34": dict(block="basic", blocks_num=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", blocks_num=(3, 4, 23, 3)),
    "resnext50": dict(block="bottleneck", blocks_num=(3, 4, 6, 3),
                      groups=32, width_per_group=4),
}

# the published Swin-T (arXiv:2103.14030): widths 96-768, heads of 32
_SWINS = {
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2),
                   num_heads=(3, 6, 12, 24), window=7, mlp_ratio=4),
}

# why a windowed transformer trunk has no such route
_NO_ROUTE = {
    "spatial": "its 7x7 attention windows, shifted by 3, and its 2x2 patch "
               "merging span the row blocks a shard holds, and the row shard "
               "exchanges halos for convolutions only",
    "int8": "the int8 route quantises convolutions; the trunk's linear "
            "layers and attention have no int8 kernel",
    "model_axis": "a model axis splits the dense heads (tensor parallel) or "
                  "the image rows (spatial); the trunk's linear layers have "
                  "no split rule and its windows cross row blocks",
}


def check_route(backbone: str, route: str) -> None:
    """Raise ``ValueError`` where ``backbone`` cannot take ``route``
    (``"spatial"``, ``"int8"`` or ``"model_axis"``), giving the reason: a
    shifted-window transformer (Swin) takes none of them."""
    if backbone.lower() in _SWINS:
        raise ValueError(f"backbone {backbone!r} has no {route} route: "
                         f"{_NO_ROUTE[route]}")


def build_backbone(name: str, dtype=torch.float32, remat: bool = False,
                   pyramid: bool = False):
    """Build a feature extractor by name, as the JAX package's registry does.

    ``hardnet39/68/85`` are the reference layout, ``hardnet39s/68s/85s`` the
    strided variants; ``swin_t`` is the Swin-T transformer, pyramid only.
    ``remat`` rematerialises HarDBlock activations in the
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
    if name in _SWINS:
        if not pyramid:
            raise ValueError(
                f"backbone {name!r} feeds an FPN only: its stages end at "
                f"strides 4-32 under output norms, and no stride-16 map of "
                f"the single-scale detector exists in it; set fpn=True")
        mod = SwinFeatureExtraction(dtype=dtype, **_SWINS[name])
        return mod, mod.out_channels
    if name not in _RESNETS:
        raise ValueError(f"unknown backbone {name!r}; expected hardnet39/68/85 "
                         f"or {sorted(_RESNETS) + sorted(_SWINS)}")
    kw = dict(_RESNETS[name])
    if not pyramid:
        kw["blocks_num"] = kw["blocks_num"][:3]
    mod = ResNetFeatureExtraction(dtype=dtype, pyramid=pyramid, **kw)
    return mod, mod.out_channels
