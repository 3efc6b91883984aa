"""Several processes, one device each: ``torch.distributed`` bring-up and the
process-boundary primitives.

The port's counterpart of the JAX package's ``parallel/multiprocess.py``.
The JAX package runs one SPMD program over a global mesh, with one
controller per host; here each device has a process of its own (the
``torchrun`` layout), and what XLA inserts there (the gradient ``psum``,
the gathers of sharded outputs) is an explicit collective of
``torch.distributed``:

* :func:`init_distributed`: one-call bring-up from the caller's arguments
  or ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``); ``nccl`` on CUDA, ``gloo`` on the CPU.
* :func:`rank_device`: the device of this rank, ``cuda:LOCAL_RANK``.
* :func:`put_global` / :func:`put_local`: place host data for the two
  conventions of the drivers: every rank holds the SAME full value (the
  unsharded eval batch), of which it takes its block of rows, or each rank
  holds only ITS shard (the per-rank ``Loader`` batches).
* :func:`fetch_global`: device values to host numpy, all-gathered along
  the batch axis so that every rank returns the same full value.
* :func:`all_reduce_`, :func:`all_gather`, :func:`broadcast_`,
  :func:`barrier`: the collectives the port issues, on any device.

Collectives run where the group's backend takes them: ``nccl`` on the
card, ``gloo`` in host memory.  A CUDA tensor in a ``gloo`` group (two
ranks on one card, as ``chip_smoke.py`` runs them) is staged through
pinned host memory and copied back; a CPU tensor in an ``nccl`` group is
staged through the rank's card.  Booleans travel as ``uint8``.

Without ``torch.distributed`` every function degrades to its local
meaning (no collective), so callers use them unconditionally; with it,
the collectives run at any world size, 1 included.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group if None); 1 without
    ``torch.distributed``."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without ``torch.distributed``."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    """True when more than one process takes part (``torchrun`` or an
    explicit :func:`init_distributed`)."""
    return world_size() > 1


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 without one)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``device`` as given if it names an index
    (``"cuda:0"``, ``"cpu"``), else ``cuda:LOCAL_RANK``, one card a process.
    Raises when a CUDA device is asked for and there is none: no entry
    point falls back to the CPU."""
    from two_stage_object_detection_tpu_torch.config import resolve_device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return resolve_device(dev)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Initialise ``torch.distributed`` for one process per device.

    Arguments come from the caller or from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``; the rendezvous ``env://`` reads
    ``MASTER_ADDR`` / ``MASTER_PORT``).  With a world of 1 and no explicit
    ``init_method`` it is a no-op.  ``backend`` defaults to ``nccl`` when
    ``device`` is a CUDA device and to ``gloo`` otherwise; either may be
    named.  On CUDA the rank's card (:func:`rank_device`) becomes the
    current device first.  Returns True if a process group is (or already
    was) up, False for the one-process no-op.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None:
        if world_size <= 1:
            return False
        init_method = "env://"
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    log.info("torch.distributed up: rank %d/%d (%s) on %s", rank, world_size,
             backend, dev)
    return True


def _comm_device(group) -> torch.device:
    """Where the tensors of a collective of ``group`` must lie."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: on its communication device
    (pinned host memory for a CUDA tensor in a gloo group), bools as uint8;
    a copy unless ``t`` already qualifies."""
    dev = _comm_device(group)
    s = t.to(torch.uint8) if t.dtype == torch.bool else t
    if s.device != dev:
        host = dev.type == "cpu" and s.is_cuda
        buf = torch.empty(s.shape, dtype=s.dtype, device=dev, pin_memory=host)
        buf.copy_(s)
        s = buf
    return s.contiguous()


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``op`` (``"sum"``, ``"max"`` or ``"min"``) of ``t`` over the ranks of
    ``group``, in place, on ``t``'s device; returns ``t``.  Every rank gets
    the same bits."""
    if not dist.is_initialized():
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    s = _staged(t, group)
    dist.all_reduce(s, red, group=group)
    if s is not t:
        t.copy_(s)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes on every rank), stacked in rank
    order: ``[world, *t.shape]`` on ``t``'s device and in its dtype."""
    if not dist.is_initialized():
        return t[None]
    n = world_size(group)
    s = _staged(t, group)
    parts = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(parts, s, group=group)
    return torch.stack(parts).to(device=t.device, dtype=t.dtype)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of rank ``src`` (a rank of the default group) on every rank,
    in place; returns ``t``."""
    if not dist.is_initialized():
        return t
    s = _staged(t, group)
    dist.broadcast(s, src, group=group)
    if s is not t:
        t.copy_(s)
    return t


def barrier(group=None) -> None:
    """Wait for every rank of ``group``: an all-reduce of one element on the
    group's communication device (which also orders it after this rank's
    pending work there)."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=_comm_device(group)),
                        group=group)


def put_local(x, device) -> torch.Tensor:
    """This rank's own shard (a per-rank ``Loader`` batch) on ``device``:
    the global batch is the rank-order concatenation of the ranks'."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    return t.to(device, non_blocking=True)


def put_global(x, device, group=None) -> torch.Tensor:
    """A value every rank holds in full (an eval batch of the unsharded
    loader): this rank's block of rows along axis 0, on ``device``.  The
    rows must divide over the ranks."""
    n, r = world_size(group), rank(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} ranks")
    b = x.shape[0] // n
    return put_local(x[r * b:(r + 1) * b], device)


def fetch_global(tree: Any, group=None) -> Any:
    """Host numpy of a tree (dicts, lists, tuples) of tensors or arrays.

    Over several ranks every leaf is all-gathered along axis 0, in rank
    order (a 0-d leaf becomes ``[world]``), so every rank returns the same
    full value.  Leaves must have equal shapes on every rank, as the
    static-shape outputs with validity masks do.  Every rank of ``group``
    must call it at the same point (the gathers are collectives).
    """
    multi = dist.is_initialized()

    def fetch(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        if multi:
            g = all_gather(x.detach(), group)
            x = g if x.dim() == 0 else g.reshape(-1, *x.shape[1:])
        return x.detach().cpu().numpy()

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return fetch(t)

    return walk(tree)
