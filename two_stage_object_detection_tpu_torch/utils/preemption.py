"""Graceful-preemption handling for training (SIGTERM -> save -> resume).

The counterpart of the JAX package's ``utils/preemption.py``.
``train()`` enters a :class:`PreemptionGuard`: the signal handler only sets
a flag, the epoch loop polls it at step boundaries, and on request the
driver saves the full ``_last`` checkpoint (parameters, batch-norm
statistics, optimiser moments, counters) and returns, so that
``train(resume=True)`` continues the run.

Several processes (``torch.distributed``): the signal reaches each rank on
its own, but the ranks must leave the loop at the same step for the
checkpoint, whose save is collective.  :meth:`PreemptionGuard.should_stop`
therefore ORs the flag over the ranks, with a one-bool ``all_reduce(MAX)``
every ``sync_every``-th poll.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

import torch

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager turning SIGTERM into a cooperative stop flag.

    Entering installs handlers for ``signals`` (default: SIGTERM, the cloud
    preemption notice) and restores the previous handlers on exit.  Entered
    off the main thread, where CPython forbids installing handlers, signals
    keep their previous behaviour and only :meth:`request` is live.
    Re-entry is safe: only the outermost ``with`` installs and restores.
    """

    def __init__(self, signals=(signal.SIGTERM,), sync_every: int = 8):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._event = threading.Event()
        self._installed = False
        self._depth = 0
        self._sync_every = max(int(sync_every), 1)
        self._polls = 0
        self._agreed = False       # the last agreement across the ranks

    def __enter__(self) -> "PreemptionGuard":
        self._depth += 1
        if self._depth > 1:
            return self
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # off the main thread, or an invalid signal partway through the
            # list: put back what was already swapped
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
            log.debug("PreemptionGuard: signal handlers not installed "
                      "(request() still works)")
        return self

    def __exit__(self, *exc) -> None:
        self._depth = max(self._depth - 1, 0)
        if self._depth == 0 and self._installed:
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
            self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self._event.set()
        log.warning("PreemptionGuard: signal %d — saving at the next step "
                    "boundary", signum)

    def request(self) -> None:
        """Programmatic graceful stop (same path as the signal)."""
        self._event.set()

    @property
    def requested(self) -> bool:
        """This process's own flag (no agreement across processes)."""
        return self._event.is_set()

    def should_stop(self, sync: Optional[bool] = None) -> bool:
        """Poll the flag; agree across the ranks of a multi-process run.

        ``sync=None`` syncs exactly when the world has more than one rank.
        The agreement is a one-bool ``all_reduce(MAX)`` over the default
        group, issued only every ``sync_every``-th poll (a collective each
        step would synchronise the host with the device every step), so a
        stop is acted on within ``sync_every`` steps of the request.  Once
        synced, the value is always the last agreement, never the local
        flag alone, and once the ranks agree to stop it stays true: every
        rank polls once a step, so all leave at the same step.
        """
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            all_reduce_, is_multiprocess)
        if sync is None:
            sync = is_multiprocess()
        if not sync:
            return self.requested
        if self._agreed:
            return True
        self._polls += 1
        if self._polls % self._sync_every:
            return False
        flag = torch.tensor([int(self.requested)], dtype=torch.int32)
        self._agreed = bool(all_reduce_(flag, "max")[0])
        return self._agreed
