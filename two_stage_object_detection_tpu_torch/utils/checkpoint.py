"""Checkpoint save/restore (``torch.save``).

The counterpart of the JAX package's ``utils/checkpoint.py`` (Orbax there):
the same names, ``FasterRCNNTrainer_best`` / ``FasterRCNNTrainer_last``,
each one directory under the weights directory, and the full train state in
it: the model's parameters and buffers (batch-norm running statistics
included), the optimiser's state dict (AdamW moments and step counts), the
gradients summed so far in the running accumulation cycle (the parameters'
``.grad``; optax keeps them in its ``MultiSteps`` state, which Orbax saves),
and the :class:`~..nets.trainer.TrainState` counters ``step`` and
``updates``, so that a restart resumes exactly, mid-cycle too.

A write goes to a temporary file in the checkpoint's directory and is moved
over the old file with ``os.replace``, so a reader finds the old checkpoint
or the new one, never a torn one.  ``wait=False`` copies the state to host
memory on the caller's thread and writes it on a background thread, as
Orbax's async save does; :func:`wait_for_saves` joins it (and raises what
the write raised).  At most one such write is in flight: a second save
waits for the first.

On a mesh over several ranks (``state.group``, set by
``parallel.mesh.place_train_state``) every rank calls both functions.
Rank 0 writes; with ``wait=True`` the others wait at a barrier until the
file is in place.  The state is the same on every rank of the data axis
except the gradients of an open accumulation cycle, which are each data
index's own until the update all-reduces them: a save gathers them, one
dict a data index, and a restore gives each its own back (which needs as
many data indices as the save had).  With a model axis each rank holds
slices of the split dense heads (``parallel/sharding.py``): a save gathers
them, their optimiser moments and gradients into the full layout, so a
tensor-parallel checkpoint loads into one process and one process's into
a mesh, and a restore cuts each rank's slices back out.  Every rank
restores from the same file.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Optional

import torch

BEST = "FasterRCNNTrainer_best"    # keep the reference's naming contract
LAST = "FasterRCNNTrainer_last"
STATE_FILE = "state.pt"

# the in-flight ``wait=False`` write: (thread, [exception or None])
_inflight: Optional[tuple] = None
_inflight_lock = threading.Lock()


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory (a copy
    even of CPU tensors: the train step goes on updating the originals)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _ranks(state) -> int:
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        world_size)
    return 1 if state.group is None else world_size(state.group)


def _accum(state):
    """The open cycle's gradients in the full layout: a dict, or over
    several data indices a list of every one's dict (gathered; a
    collective)."""
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_full, split_parameters)
    split = split_parameters(state.model)
    named = [(n, gather_full(p.grad, split[n][0], split[n][1])
              if n in split else p.grad)
             for n, p in state.model.named_parameters() if p.grad is not None]
    if _ranks(state) == 1 or not named:     # (no open cycle on any rank)
        return {n: _to_host(g) for n, g in named}
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_gather)
    gathered = [(n, _to_host(all_gather(g, state.group))) for n, g in named]
    return [{n: g[r] for n, g in gathered} for r in range(_ranks(state))]


def _snapshot(state, accum) -> dict:
    """The checkpoint's payload on the host, in the full layout (split
    parameters and their moments gathered: a collective)."""
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_optimizer_state, gather_state_dict)
    return {"model": _to_host(gather_state_dict(state.model)),
            "optimizer": _to_host(gather_optimizer_state(state)),
            "accum": accum,
            "step": int(state.step), "updates": int(state.updates)}


def _write(payload: dict, full: str) -> None:
    os.makedirs(full, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".pt", dir=full)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(full, STATE_FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path: str, state, name: str = LAST,
                    wait: bool = True) -> str:
    """Save a :class:`~..nets.trainer.TrainState` under ``path/name``.

    ``wait=True`` (default) returns once the file is in place.
    ``wait=False`` returns once the state is copied to host memory and
    writes it on a background thread, overlapping the write with the next
    train steps; call :func:`wait_for_saves` before relying on the file.
    Returns the checkpoint's directory.
    """
    global _inflight
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        barrier, rank, world_size)
    full = os.path.abspath(os.path.join(path, name))
    wait_for_saves()                     # one async save in flight at a time
    payload = _snapshot(state, _accum(state))
    multi = state.group is not None and world_size() > 1
    if multi and rank() != 0:
        if wait:
            barrier()                    # until rank 0's file is in place
        return full
    if wait:
        _write(payload, full)
        if multi:
            barrier()
        return full
    error: list = [None]

    def run():
        try:
            _write(payload, full)
        except BaseException as e:       # handed to wait_for_saves
            error[0] = e

    t = threading.Thread(target=run, name="checkpoint-save", daemon=False)
    with _inflight_lock:
        _inflight = (t, error)
    t.start()
    return full


def wait_for_saves() -> None:
    """Block until any ``wait=False`` save is on disk; re-raise its error."""
    global _inflight
    with _inflight_lock:
        pending, _inflight = _inflight, None
    if pending is not None:
        t, error = pending
        t.join()
        if error[0] is not None:
            raise error[0]


def restore_checkpoint(path: str, state, name: str = BEST,
                       params_only: bool = False):
    """Restore ``path/name`` into ``state`` in place; ``None`` if absent.

    ``params_only`` restores the parameters and batch-norm statistics only:
    the optimiser and the counters stay as they are (the reference's
    ``pre_train=True``: weights restored, optimiser fresh).  Returns
    ``state``.
    """
    wait_for_saves()                    # a pending async save may be this file
    file = os.path.join(os.path.abspath(os.path.join(path, name)), STATE_FILE)
    if not os.path.exists(file):
        return None
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        shard_optimizer_state, shard_state_dict, split_parameters)
    payload = torch.load(file, map_location="cpu", weights_only=True)
    state.model.load_state_dict(shard_state_dict(state.model,
                                                 payload["model"]))
    if not params_only:
        state.optimizer.load_state_dict(shard_optimizer_state(
            state.model, payload["optimizer"]))
        accum = payload["accum"]
        if isinstance(accum, list) or (accum and _ranks(state) > 1):
            saved = len(accum) if isinstance(accum, list) else 1
            if saved != _ranks(state):
                raise ValueError(
                    f"{file} holds an open accumulation cycle of {saved} "
                    f"rank(s); resume it with as many, not {_ranks(state)}")
            from two_stage_object_detection_tpu_torch.parallel.multiprocess \
                import rank
            accum = accum[rank(state.group)]
        split = split_parameters(state.model)
        for n, p in state.model.named_parameters():
            g = accum.get(n)
            if g is not None and n in split:
                dim, _, index, size = split[n]
                g = g.chunk(size, dim)[index].clone()
            p.grad = None if g is None else g.to(p.device)
        state.step = int(payload["step"])
        state.updates = int(payload["updates"])
    return state
