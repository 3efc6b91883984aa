"""Device meshes and batch sharding: the data axis.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  There a
``jax.sharding.Mesh`` with a ``data`` and a ``model`` axis spans every
device, and XLA inserts the gradient ``psum`` because the whole train step
is one program.  Here a :class:`Mesh` is either

* over processes, one device each (the ``torchrun`` layout): its ``data``
  axis is the process group of the ranks, each rank holds its device and
  its shard of every batch, and the gradient mean is an explicit
  all-reduce (``nets/trainer.py``); or
* over the devices of one process: the replicas of a
  :class:`~..serving.Predictor`, which splits each bucket's rows over them.

The ``model`` axis (tensor-parallel dense heads, image rows over
``model``) is not ported yet: asking for it raises
``NotImplementedError`` naming its ROADMAP.md entry.
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

MODEL_AXIS = ("the model axis of parallel/ (tensor-parallel dense heads, "
              "image rows over 'model' with halo exchanges) is the next "
              "slice of the port (ROADMAP.md, 'Modules to port', item 4)")


def model_axis_unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {MODEL_AXIS}")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` mesh.

    ``shape``: ``{"data": n, "model": 1}``.  ``devices``: this process's
    devices on the mesh, in data order (one in a mesh over processes).
    ``group``: the process group of the data axis, or None for a mesh
    within one process.
    """

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    group: Any = None

    @property
    def processes(self) -> int:
        """Processes on the data axis (1 for a mesh within one process)."""
        return 1 if self.group is None else world_size(self.group)

    @property
    def data_index(self) -> int:
        """This process's position on the data axis."""
        return 0 if self.group is None else rank(self.group)

    @property
    def device(self) -> torch.device:
        """This process's device; a mesh of several local devices has none."""
        if len(self.devices) != 1:
            raise ValueError(f"a mesh over {len(self.devices)} devices of one "
                             "process has no single device")
        return self.devices[0]


def _local_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, model)`` mesh.

    Under ``torch.distributed`` (any world size) the data axis is the
    default group, one rank a device: ``n_data`` must be the world size,
    and ``devices`` may name this rank's one device (default
    :func:`~.multiprocess.rank_device`).  Without it the mesh spans
    ``devices`` of this process (default: every CUDA device), the first
    ``n_data`` of them.  ``n_model`` above 1 raises (:data:`MODEL_AXIS`).
    """
    if n_model != 1:
        raise model_axis_unported(f"make_mesh(n_model={n_model})")
    if dist.is_initialized():
        n = world_size()
        if n_data not in (None, n):
            raise ValueError(f"one device a process: a data axis of {n_data} "
                             f"needs {n_data} ranks, the world has {n}")
        if devices is not None and len(devices) != 1:
            raise ValueError("a rank holds one device of the mesh, "
                             f"got {len(devices)}")
        dev = rank_device(devices[0] if devices is not None else "cuda")
        return Mesh({"data": n, "model": 1}, (dev,), dist.group.WORLD)
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _local_devices())
    n_data = len(devs) if n_data is None else n_data
    if not 1 <= n_data <= len(devs):
        raise ValueError(f"a data axis of {n_data} over {len(devs)} devices")
    return Mesh({"data": n_data, "model": 1}, tuple(devs[:n_data]))


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
    batch divides into (:func:`data_axis`).  Under ``torch.distributed``
    that is every rank, one device each (``devices``: this rank's);
    within one process, ``devices`` (default: every CUDA device).  None on
    a single device."""
    if n_model != 1:
        raise model_axis_unported(f"auto_mesh(n_model={n_model})")
    if dist.is_initialized():
        n = world_size()
        if n <= 1:
            return None
        n_data, _ = data_axis(batch_size, n, n)
        return make_mesh(n_data, devices=devices)
    devs = list(devices) if devices is not None else _local_devices()
    if len(devs) <= 1:
        return None
    n_data, _ = data_axis(batch_size, len(devs))
    return None if n_data <= 1 else make_mesh(n_data, devices=devs)


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
    """One copy of ``tree`` per device of the mesh in this process, in
    data order: tensors copied to each device, a module deep-copied there
    (the first is ``tree`` itself if it is already on the first device).
    Over processes the list has this rank's copy; every rank holds the same
    value, as with the JAX package's ``replicate``."""
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

    return [to(tree, d) for d in mesh.devices]


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


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor a rank must hold equal to the others: parameters,
    buffers (the running statistics, the anchors) and optimiser state."""
    out = list(state.model.state_dict().values())
    for s in state.optimizer.state.values():
        out += [v for v in s.values() if isinstance(v, torch.Tensor)]
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
    rank (one flat buffer per dtype), gives the state the data group (the
    train step's gradient all-reduce, :func:`~..nets.trainer.train_step`)
    and, over more than one rank, gives every batch norm of the model the
    group (cross-replica statistics, ``models/layers.py``).  ``debug``
    then asserts that the ranks hold the same bits.  Returns ``state``.
    """
    from two_stage_object_detection_tpu_torch.models.layers import (
        set_data_group)
    if mesh.group is None:
        raise ValueError("place_train_state needs a mesh over processes, one "
                         "device each (launch under torchrun)")
    if state.model.device != mesh.device:
        raise ValueError(f"the state is on {state.model.device}, this rank's "
                         f"mesh device is {mesh.device}")
    with torch.no_grad():
        _coalesced(state_tensors(state),
                   lambda flat: broadcast_(flat, 0, mesh.group))
    state.group = mesh.group
    set_data_group(state.model, mesh.group if mesh.processes > 1 else None)
    if debug:
        assert_replicated(state_tensors(state), mesh.group)
    return state

