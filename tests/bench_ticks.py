"""A clock for the benchmark's serving drivers in CPU tests.

A driver's window is ``--seconds`` on its clock, and it raises when no
request ends inside it.  On the wall clock, a CPU test's window holds as
many requests as the machine's load lets it, none on a busy one, and
which served images the driver checks depends on how many it completed.
:func:`tick_clock` advances a fixed tick a read instead, so the window
holds the same requests on every run, however busy the machine.
"""

import itertools
import time

# reads of the clock a request: the loop's check of the window, the
# predictor proxy's start and end, and the request's end
READS_A_REQUEST = 4


def tick_clock(window_s: float, requests: int):
    """A clock whose ``window_s`` holds ``requests`` whole requests."""
    ticks = itertools.count()
    base = time.perf_counter()
    # the last request ends at READS_A_REQUEST * requests ticks, inside the
    # window; the next check of the window, a tick later, falls outside
    step = window_s / (READS_A_REQUEST * requests + 0.5)
    return lambda: base + next(ticks) * step


def ticking_driver(cell, window_s: float, requests: int):
    """``cell``'s driver module with :func:`tick_clock` as its clock."""
    driver = cell.driver()
    driver.clock = tick_clock(window_s, requests)
    return driver
