"""Carry flax variables across into the port's modules, and back.

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

``to_jax_variables(model)`` is the way back: ``(params, batch_stats)`` as
nested dicts of numpy arrays in flax's names and layouts, of the values or,
with ``grads=True``, of the parameters' gradients, so that a train step is
compared with the JAX package leaf by leaf.  A round trip is the identity.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, Conv, Dense)
from two_stage_object_detection_tpu_torch.models.resnet import PReLU

# layer type -> flax leaf -> (port name, flax-to-port, port-to-flax)
_RULES = {
    Conv: {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1),
                      lambda a: a.transpose(2, 3, 1, 0)),
           "bias": ("bias", None, None)},
    Dense: {"kernel": ("weight", lambda a: a.T, lambda a: a.T),
            "bias": ("bias", None, None)},
    BatchNorm: {"scale": ("weight", None, None), "bias": ("bias", None, None),
                "mean": ("running_mean", None, None),
                "var": ("running_var", None, None)},
    PReLU: {"alpha": ("weight", lambda a: a.reshape(1),
                      lambda a: a.reshape(()))},
}
_BATCH_STATS = ("mean", "var")


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
        name, convert, _ = rule
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


def to_jax_variables(model: nn.Module, grads: bool = False):
    """The port's variables in flax's names and layouts.

    Returns ``(params, batch_stats)``, nested dicts of float32 numpy arrays
    keyed by the flax module path.  ``grads=True`` puts each parameter's
    ``.grad`` in place of its value (zeros where it has none) and leaves
    ``batch_stats`` empty.
    """
    params: dict = {}
    stats: dict = {}
    for path, mod in model.named_modules():
        for leaf, (name, _, back) in _RULES.get(type(mod), {}).items():
            t = getattr(mod, name, None)
            if t is None:                       # a conv without bias
                continue
            is_stat = leaf in _BATCH_STATS
            if grads:
                if is_stat:
                    continue
                t = torch.zeros_like(t) if t.grad is None else t.grad
            arr = t.detach().to("cpu", torch.float32).contiguous().numpy()
            node = stats if is_stat else params
            for key in path.split("."):
                node = node.setdefault(key, {})
            # (np.ascontiguousarray would turn PReLU's 0-d alpha into [1])
            node[leaf] = np.array(arr if back is None else back(arr),
                                  dtype=np.float32, order="C")
    return params, stats
