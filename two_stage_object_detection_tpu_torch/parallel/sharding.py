"""Tensor parallelism over a mesh's ``model`` axis: the sharding rules and
the split dense heads.

The port's counterpart of the JAX package's ``parallel/sharding.py``.  The
rules are the same (:func:`infer_param_sharding`): a two-dimensional
weight of a dense layer (``fc1``, ``fc2``, ``cls_loc``, ``score``) splits
its output features over ``model``, which in torch's ``[out, in]`` layout
is dim 0; everything else stays whole: every convolution (HarDNet's
trunk is depth-wise throughout, and a channel split of a neighbouring 1x1
conv would propagate into its grouped convs), every bias, every batch
norm, and any weight whose output size the axis does not divide.

Where the JAX package hands those shardings to XLA, which inserts the
gathers, the port's model axis crosses ranks (one process a device): a
rank holds its rows of each split weight (:func:`shard_train_state`), and
a split layer computes its slice of the output features and gathers the
full output over the model group before the next layer, and so before the
softmax and the box decode (:func:`column_parallel_linear`).  The layer's
input gradient is a sum over the model ranks' slices, all-reduced in the
backward.  Its bias is added after the gather, so every rank of the group
computes the bias's whole gradient.

Checkpoints hold the full layout: :func:`gather_state_dict` and
:func:`gather_optimizer_state` assemble it over the model group (a
collective), :func:`shard_state_dict` and :func:`shard_optimizer_state`
cut this rank's slices back out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.parallel import multiprocess


def infer_param_sharding(model: nn.Module, mesh, model_axis: str = "model"
                         ) -> Dict[str, Optional[int]]:
    """Each parameter's split dimension over ``model_axis``, or None.

    ``{name: 0}`` for the weight of a dense layer (every 2-D parameter of
    the port is one: ``fc1``, ``fc2``, ``cls_loc``, ``score``) whose output
    features the axis divides (the full size, on a model already split
    too), ``{name: None}`` for every other parameter; a ``model`` axis of 1
    replicates everything.
    """
    from two_stage_object_detection_tpu_torch.models.layers import Dense
    n = mesh.shape[model_axis]
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            out[name] = (0 if n > 1 and isinstance(mod, Dense)
                         and pname == "weight" and mod.out_features % n == 0
                         else None)
    return out


# ------------------------------------------------------------ the layer
class _ToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return multiprocess.all_reduce_(dy.contiguous().clone(), "sum",
                                        ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's slice of the last axis, concatenated in rank
    order; the backward takes this rank's slice (every rank of the group
    computes the same gradient of the gathered output)."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.k = index, y.shape[-1]
        parts = multiprocess.all_gather(y.contiguous(), group)
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, dy):
        lo = ctx.index * ctx.k
        return dy[..., lo:lo + ctx.k].contiguous(), None, None


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, group, index: int
                           ) -> torch.Tensor:
    """``x @ W.T + b`` with ``W``'s output features split over the ranks of
    ``group``: ``weight`` is this rank's (``index``-th) block of rows.
    Returns the full output on every rank."""
    y = torch.nn.functional.linear(_ToModel.apply(x, group), weight)
    return _GatherFromModel.apply(y, group, index) + bias


# ------------------------------------------------------------ the state
def _block(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    return t.chunk(size, dim)[index]


def split_parameters(model: nn.Module) -> Dict[str, tuple]:
    """``{name: (dim, group, index, size)}`` of the split parameters of a
    model placed on a mesh with a model axis (empty otherwise)."""
    return {f"{n}.weight" if n else "weight": (0, *m.tp)
            for n, m in model.named_modules() if getattr(m, "tp", None)}


def shard_train_state(state, mesh) -> None:
    """Keep this rank's slice of every parameter the rules split, in place:
    each such weight becomes a parameter of its block of rows, its module
    gathers over ``mesh.model_group``, and the optimiser is rebuilt over the
    new parameters with its state (and any open cycle's gradients) sliced
    the same way; AdamW is element-wise, so the slices of the whole state
    are the sliced state's."""
    model, opt = state.model, state.optimizer
    split = {n: d for n, d in infer_param_sharding(model, mesh).items()
             if d is not None}
    size, index = mesh.shape["model"], mesh.model_index
    old = dict(model.named_parameters())
    for name, dim in split.items():
        mod_name, pname = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        p = old[name]
        new = nn.Parameter(_block(p.detach(), dim, index, size).clone())
        if p.grad is not None:
            new.grad = _block(p.grad, dim, index, size).clone()
        setattr(mod, pname, new)
        mod.tp = (mesh.model_group, index, size)
    rebuilt = type(opt)(model.parameters(), lr=opt.defaults["lr"])
    rebuilt.defaults.update(opt.defaults)
    for g_old, g_new in zip(opt.param_groups, rebuilt.param_groups):
        g_new.update({k: v for k, v in g_old.items() if k != "params"})
    for (name, p_old), p_new in zip(old.items(), model.parameters()):
        st = opt.state.get(p_old)
        if st:
            rebuilt.state[p_new] = {
                k: (_block(v, split[name], index, size).clone()
                    if name in split and _full_like(v, p_old) else v)
                for k, v in st.items()}
    state.optimizer = rebuilt


def _full_like(v, p: torch.Tensor) -> bool:
    """An optimiser state tensor laid out like its parameter ``p`` (the
    moments; not AdamW's scalar step count)."""
    return isinstance(v, torch.Tensor) and v.shape == p.shape and v.dim() > 0


def gather_full(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of which every rank of ``group`` holds a block along
    ``dim`` (a collective)."""
    return torch.cat(multiprocess.all_gather(t.contiguous(), group).unbind(0),
                     dim)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the full layout: each split parameter
    gathered over its model group (every rank of the mesh calls it)."""
    sd = model.state_dict()
    for name, (dim, group, _, _) in split_parameters(model).items():
        sd[name] = gather_full(sd[name], dim, group)
    return sd


def shard_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full-layout state dict cut to this rank's slices of the split
    parameters, for ``model.load_state_dict``."""
    out = dict(sd)
    for name, (dim, _, index, size) in split_parameters(model).items():
        out[name] = _block(sd[name], dim, index, size)
    return out


def gather_optimizer_state(state) -> dict:
    """``state.optimizer.state_dict()`` in the full layout: the moments of
    each split parameter gathered over its model group (a collective)."""
    osd = state.optimizer.state_dict()
    split = split_parameters(state.model)
    if not split:
        return osd
    names = [n for n, _ in state.model.named_parameters()]
    params = list(state.model.parameters())
    out = dict(osd, state=dict(osd["state"]))
    for i in sorted(osd["state"]):
        if names[i] not in split:
            continue
        dim, group, _, _ = split[names[i]]
        out["state"][i] = {k: gather_full(v, dim, group)
                           if _full_like(v, params[i]) else v
                           for k, v in osd["state"][i].items()}
    return out


def shard_optimizer_state(model: nn.Module, osd: Mapping) -> dict:
    """A full-layout optimiser state dict cut to this rank's slices of the
    split parameters' moments, for ``optimizer.load_state_dict``."""
    split = split_parameters(model)
    names = [n for n, _ in model.named_parameters()]
    out = dict(osd, state=dict(osd["state"]))
    for i, st in osd["state"].items():
        name = names[int(i)]
        if name not in split:
            continue
        dim, _, index, size = split[name]
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        full = (mod.out_features, mod.in_features)
        out["state"][i] = {k: _block(v, dim, index, size)
                           if isinstance(v, torch.Tensor)
                           and tuple(v.shape) == full else v
                           for k, v in st.items()}
    return out
