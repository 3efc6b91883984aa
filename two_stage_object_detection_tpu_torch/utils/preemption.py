"""Graceful-preemption handling for training (SIGTERM -> save -> resume).

The counterpart of the JAX package's ``utils/preemption.py``, for one
process.  ``train()`` enters a :class:`PreemptionGuard`: the signal handler
only sets a flag, the epoch loop polls it at step boundaries, and on request
the driver saves the full ``_last`` checkpoint (parameters, batch-norm
statistics, optimiser moments, counters) and returns, so that
``train(resume=True)`` continues the run.

Not ported: the cross-process agreement of multi-process runs
(``should_stop(sync=True)`` there ORs the flag over every process).  It
waits for ``parallel/``; here ``sync`` is accepted and a true value raises.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager turning SIGTERM into a cooperative stop flag.

    Entering installs handlers for ``signals`` (default: SIGTERM, the cloud
    preemption notice) and restores the previous handlers on exit.  Entered
    off the main thread, where CPython forbids installing handlers, signals
    keep their previous behaviour and only :meth:`request` is live.
    Re-entry is safe: only the outermost ``with`` installs and restores.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._event = threading.Event()
        self._installed = False
        self._depth = 0

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
        return self._event.is_set()

    def should_stop(self, sync: Optional[bool] = None) -> bool:
        """Poll the flag.  ``sync`` false or ``None``: this process's flag.
        A true ``sync`` (agreement across processes) raises until
        ``parallel/`` is ported."""
        if sync:
            raise NotImplementedError(
                "should_stop(sync=True) agrees across processes, which "
                "needs parallel/ (ROADMAP.md, 'Modules to port')")
        return self.requested
