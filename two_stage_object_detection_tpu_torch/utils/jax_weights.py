"""Carry flax variables across into the port's modules.

``load_jax_variables(model, params, batch_stats)`` takes the JAX package's
variable trees as nested dicts of numpy arrays (so this module needs no
JAX) and fills the port's modules, whose submodules carry the flax names.
One rule per layer type:

* conv ``kernel`` HWIO -> ``weight`` OIHW; ``bias`` as is;
* dense ``kernel [in, out]`` -> ``weight [out, in]``;
* batch norm ``scale``/``bias`` -> ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* PReLU scalar ``alpha`` -> the 1-element ``weight``.

It raises on a flax leaf it does not consume, on a port parameter or buffer
left unfilled, and on any shape that does not match.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, Conv, Dense)
from two_stage_object_detection_tpu_torch.models.resnet import PReLU

_RULES = {
    Conv: {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
           "bias": ("bias", None)},
    Dense: {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)},
    BatchNorm: {"scale": ("weight", None), "bias": ("bias", None),
                "mean": ("running_mean", None), "var": ("running_var", None)},
    PReLU: {"alpha": ("weight", lambda a: a.reshape(1))},
}


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_jax_variables(model: nn.Module, params: Mapping,
                       batch_stats: Mapping | None = None) -> nn.Module:
    """Copy flax ``params`` / ``batch_stats`` (numpy leaves) into ``model``.

    Returns ``model``.  Raises ``KeyError`` for an unknown or unfilled name,
    ``ValueError`` for a shape mismatch.
    """
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    filled = set()
    leaves = list(_leaves(params)) + list(_leaves(batch_stats or {}))
    for path, value in leaves:
        mod_path, leaf = ".".join(path[:-1]), path[-1]
        try:
            mod = model.get_submodule(mod_path)
        except AttributeError:
            raise KeyError(f"flax variable {'/'.join(path)}: no module "
                           f"{mod_path!r} in {type(model).__name__}") from None
        rule = _RULES.get(type(mod), {}).get(leaf)
        if rule is None:
            raise KeyError(f"flax variable {'/'.join(path)} has no counterpart "
                           f"in {type(mod).__name__} {mod_path!r}")
        name, convert = rule
        arr = np.asarray(value, dtype=np.float32)
        if convert is not None:
            arr = convert(arr)
        key = f"{mod_path}.{name}"
        target = state[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"flax variable {'/'.join(path)}: shape "
                             f"{tuple(arr.shape)} does not match {key} "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        filled.add(key)
    persistent = {k for k in state if k in model.state_dict()}
    missing = sorted(persistent - filled)
    if missing:
        raise KeyError(f"{len(missing)} port variables have no flax "
                       f"counterpart: {missing[:8]}")
    return model
