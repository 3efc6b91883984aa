"""Device meshes and batch sharding: the data and the model axis.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  There a
``jax.sharding.Mesh`` with a ``data`` and a ``model`` axis spans every
device, and XLA inserts the gradient ``psum`` and the gathers of sharded
parameters because the whole train step is one program.  Here a
:class:`Mesh` is either

* over processes, one device each (the ``torchrun`` layout): the JAX grid
  ``world = n_data * n_model`` with ``rank = d * n_model + m``.  The
  **data group** (the ranks of one ``m``) carries the gradient all-reduce
  and the cross-replica batch norm, and each of its ranks holds its shard
  of every batch; the **model group** (the ranks of one ``d``, which read
  the same batch) carries the gathers of the tensor-parallel dense heads
  (:mod:`.sharding`).  Every collective is explicit (``nets/trainer.py``,
  ``models/layers.py``, :mod:`.sharding`); or
* over the devices of one process: the replicas of a
  :class:`~..serving.Predictor`, which splits each bucket's rows over the
  data axis.

Image rows over ``model`` (``spatial``) are not ported yet: asking for them
raises ``NotImplementedError`` naming their ROADMAP.md entry.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
    all_reduce_, broadcast_, put_global, put_local, rank, rank_device,
    world_size)

MODEL_AXIS = ("image rows over the model axis (spatial sharding of "
              "parallel/, with a halo exchange at every 3x3 convolution and "
              "pooling window) are the last module of the port still to "
              "come (ROADMAP.md, 'Modules to port', item C)")


def model_axis_unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {MODEL_AXIS}")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` mesh.

    ``shape``: ``{"data": n_data, "model": n_model}``.  ``devices``: this
    process's devices on the mesh (one in a mesh over processes; the grid
    in row-major ``d * n_model + m`` order within one process).
    ``group``: the process group of the data axis, None within one
    process; ``model_group`` and ``model_index``: the process group of
    this rank's model axis and its place there (None and 0 without a model
    axis over processes).
    """

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    group: Any = None
    model_group: Any = None
    model_index: int = 0

    @property
    def processes(self) -> int:
        """Processes on the data axis (1 for a mesh within one process)."""
        return 1 if self.group is None else world_size(self.group)

    @property
    def data_index(self) -> int:
        """This process's position on the data axis."""
        return 0 if self.group is None else rank(self.group)

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """One device of each data index in this process: the first of
        its row of the grid (a mesh over processes has one)."""
        return self.devices[::self.shape["model"]]

    @property
    def device(self) -> torch.device:
        """This process's device; a mesh of several local devices has none."""
        if len(self.devices) != 1:
            raise ValueError(f"a mesh over {len(self.devices)} devices of one "
                             "process has no single device")
        return self.devices[0]


def _local_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _axis_groups(n_data: int, n_model: int):
    """``(data group, model group)`` of this rank on the ``(n_data,
    n_model)`` grid of the default group.  Every rank creates every
    subgroup, in the same order (``dist.new_group``'s rule)."""
    data = [dist.new_group([d * n_model + m for d in range(n_data)])
            for m in range(n_model)]
    model = [dist.new_group([d * n_model + m for m in range(n_model)])
             for d in range(n_data)]
    d, m = divmod(rank(), n_model)
    return data[m], model[d]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, model)`` mesh.

    Under ``torch.distributed`` (any world size) the mesh is the default
    group, one rank a device: ``n_data * n_model`` must be the world size
    (``n_data`` defaults to its share), and ``devices`` may name this
    rank's one device (default :func:`~.multiprocess.rank_device`).  With
    ``n_model`` 1 the data group is the default group itself; otherwise
    every rank builds the data and model subgroups (a collective call).
    Without it the mesh spans ``devices`` of this process (default: every
    CUDA device), the first ``n_data * n_model`` of them.
    """
    if n_model < 1:
        raise ValueError(f"a model axis of {n_model}")
    if dist.is_initialized():
        n = world_size()
        if n_data is None:
            n_data = n // n_model
        if n_data * n_model != n:
            raise ValueError(f"one device a process: a data axis of {n_data} "
                             f"and a model axis of {n_model} need "
                             f"{n_data * n_model} ranks, the world has {n}")
        if devices is not None and len(devices) != 1:
            raise ValueError("a rank holds one device of the mesh, "
                             f"got {len(devices)}")
        dev = rank_device(devices[0] if devices is not None else "cuda")
        shape = {"data": n_data, "model": n_model}
        if n_model == 1:
            return Mesh(shape, (dev,), dist.group.WORLD)
        data, model = _axis_groups(n_data, n_model)
        return Mesh(shape, (dev,), data, model, rank() % n_model)
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _local_devices())
    n_data = len(devs) // n_model if n_data is None else n_data
    if n_data < 1 or n_data * n_model > len(devs):
        raise ValueError(f"a data axis of {n_data} and a model axis of "
                         f"{n_model} over {len(devs)} devices")
    return Mesh({"data": n_data, "model": n_model},
                tuple(devs[:n_data * n_model]))


def data_axis(batch_size: int, n_devices: int, n_processes: int = 1,
              n_model: int = 1) -> Tuple[int, int]:
    """``(n_data, devices used a process)`` of the JAX package's
    ``auto_mesh``: over one process, the largest divisor of the batch that
    the devices hold; over several, ``batch_size`` is a process's, and a
    process's factor prefers one whose global data axis also divides one
    batch (the unsharded eval loader splits a batch over the whole axis),
    else any divisor of the batch."""
    if n_processes > 1:
        cap = max(n_devices // n_processes // n_model, 1)
        ok_eval = [d for d in range(1, cap + 1)
                   if batch_size % (d * n_processes) == 0]
        d_local = max(ok_eval) if ok_eval else max(
            d for d in range(1, cap + 1) if batch_size % d == 0)
        return d_local * n_processes, d_local
    cap = max(n_devices // n_model, 1)
    n = max(d for d in range(1, cap + 1) if batch_size % d == 0)
    return n, n


def auto_mesh(batch_size: int, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """Default training mesh: data-parallel over as many devices as the
    batch divides into (:func:`data_axis`), times the ``model`` factor.
    Under ``torch.distributed`` that is every rank, one device each
    (``devices``: this rank's; the world must divide by ``n_model``, and
    each of the ``world / n_model`` data indices reads ``batch_size``
    images); within one process, ``devices`` (default: every CUDA device).
    None on a single device."""
    if dist.is_initialized():
        n = world_size()
        if n <= 1:
            return None
        if n_model == 1:
            n_data, _ = data_axis(batch_size, n, n)
        else:
            n_data = n // n_model
        return make_mesh(n_data, n_model, devices=devices)
    devs = list(devices) if devices is not None else _local_devices()
    if len(devs) <= 1 and n_model == 1:
        return None
    n_data, _ = data_axis(batch_size, len(devs), n_model=n_model)
    return None if n_data * n_model <= 1 else make_mesh(n_data, n_model,
                                                        devs)


def auto_mesh_spatial(batch_size: int, devices=None):
    """The data + spatial mesh: image rows over ``model``; not ported."""
    raise model_axis_unported("auto_mesh_spatial")


def shard_batch_spatial(batch, mesh: Mesh, local: bool = True):
    """Batch over ``data``, image rows over ``model``; not ported."""
    raise model_axis_unported("shard_batch_spatial")


def shard_batch(batch: Dict, mesh: Mesh, local: bool = True
                ) -> Dict[str, torch.Tensor]:
    """This process's part of a batch dict, on its device.

    ``local=True``: each rank passes only ITS batch (its ``Loader``
    shard); the global batch is the rank-order concatenation.
    ``local=False``: every rank passes the SAME full batch (the unsharded
    eval loader) and takes its block of rows.
    """
    if local:
        return {k: put_local(v, mesh.device) for k, v in batch.items()}
    return {k: put_global(v, mesh.device, mesh.group)
            for k, v in batch.items()}


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per data index of the mesh in this process, in
    data order (:attr:`Mesh.data_devices`: the model axis's other devices
    would compute the same rows): tensors copied to each device, a module
    deep-copied there (the first is ``tree`` itself if it is already on the
    first device).  Over processes the list has this rank's copy; every
    rank holds the same value, as with the JAX package's ``replicate``."""
    def to(t, dev):
        if isinstance(t, torch.nn.Module):
            return t if _module_device(t) == dev else copy.deepcopy(t).to(dev)
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        if isinstance(t, dict):
            return {k: to(v, dev) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to(v, dev) for v in t)
        return t

    return [to(tree, d) for d in mesh.data_devices]


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _coalesced(tensors: Sequence[torch.Tensor], fn) -> None:
    """Apply the in-place collective ``fn`` to ``tensors`` as one flat
    buffer per (dtype, device), and copy the result back."""
    buckets: Dict[tuple, list] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        at = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n


def state_tensors(state, replicated_only: bool = False
                  ) -> List[torch.Tensor]:
    """Every tensor a rank must hold equal to the other ranks of its data
    group: parameters, buffers (the running statistics, the anchors) and
    optimiser state.  ``replicated_only``: leave out the split parameters
    and their optimiser state (what the ranks of a model group hold
    equal)."""
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        split_parameters)
    skip = set(split_parameters(state.model)) if replicated_only else set()
    out = [t for k, t in state.model.state_dict().items() if k not in skip]
    for (name, p) in state.model.named_parameters():
        if name not in skip:
            out += [v for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor)]
    return out


def assert_replicated(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Raise unless every rank of ``group`` holds the same bits in
    ``tensors`` (the element-wise maximum and minimum over the ranks
    equal this rank's values)."""
    for t in tensors:
        local = t.detach().reshape(-1)
        if local.dtype == torch.bool:
            local = local.to(torch.uint8)
        hi = all_reduce_(local.clone(), "max", group)
        lo = all_reduce_(local.clone(), "min", group)
        if not (torch.equal(hi, local) and torch.equal(lo, local)):
            raise AssertionError(
                f"a tensor of shape {tuple(t.shape)} differs across ranks")


def place_train_state(state, mesh: Mesh, debug: bool = False):
    """Put a :class:`~..nets.trainer.TrainState` on a mesh over processes.

    Broadcasts rank 0's parameters, buffers and optimiser state to every
    rank (one flat buffer per dtype) and gives the state the data group
    (the train step's gradient all-reduce,
    :func:`~..nets.trainer.train_step`) and the model group; over more than
    one data index every batch norm of the model takes the data group
    (cross-replica statistics, ``models/layers.py``).  With a model axis,
    each rank then keeps its slice of every parameter the tensor-parallel
    rules split, and the optimiser is rebuilt over the slices
    (:func:`~.sharding.shard_train_state`).  ``debug`` then asserts that
    the ranks of each data group hold the same bits, and those of each
    model group the same replicated bits.  Returns ``state``.
    """
    from two_stage_object_detection_tpu_torch.models.layers import (
        set_data_group)
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        shard_train_state)
    if mesh.group is None:
        raise ValueError("place_train_state needs a mesh over processes, one "
                         "device each (launch under torchrun)")
    if state.model.device != mesh.device:
        raise ValueError(f"the state is on {state.model.device}, this rank's "
                         f"mesh device is {mesh.device}")
    with torch.no_grad():
        _coalesced(state_tensors(state), lambda flat: broadcast_(flat, 0))
    state.group, state.model_group = mesh.group, mesh.model_group
    set_data_group(state.model, mesh.group if mesh.processes > 1 else None)
    if mesh.model_group is not None:
        shard_train_state(state, mesh)
    if debug:
        assert_replicated(state_tensors(state), mesh.group)
        if mesh.model_group is not None:
            assert_replicated(state_tensors(state, replicated_only=True),
                              mesh.model_group)
    return state
