"""The host decode path of both packages, made the same in one test
process.

Both packages decode and pack through their own build of
``native/preprocess.cpp`` when it loads, and through PIL / numpy when it
does not; a test that holds one package's host output against the other's
must have both take the same path.  This module imports both packages'
``data/native.py`` and nothing else.
"""

import os
import time

from two_stage_object_detection_tpu.data import native as jnative
from two_stage_object_detection_tpu_torch.data import native


def same_native_path(mp, timeout: float = 60.0) -> bool:
    """Make both packages take the same host path (native library or
    numpy/PIL); returns whether both use their library.

    The JAX package builds its library with an in-place ``make`` into
    ``native/libpreprocess.so`` and caches a failed load for the life of
    the process (``data/native.py``: ``_tried``).  Under ``pytest -n``
    one worker can load the file while another worker's ``make`` is still
    writing it, and keep that failure, while the port's library (built
    under ``_build/`` and published atomically) loads.  So, through ``mp``
    (a ``MonkeyPatch``): each time the file has not changed for 2 s, the
    JAX package's cached failure is reset and the load tried again (with
    its own ``make`` held back, so as not to write the file twice at
    once), until it loads; if it still fails after ``timeout`` seconds,
    the port's library is hidden too.  A process spawned afterwards loads
    each library afresh."""
    if jnative.available() or not native.available():
        return jnative.available() and native.available()
    so = jnative._SO_PATH
    mp.setattr(jnative, "_build", lambda: os.path.exists(so))
    deadline = time.monotonic() + timeout
    while True:
        if os.path.exists(so) and time.time() - os.path.getmtime(so) > 2.0:
            mp.setattr(jnative, "_lib", None)
            mp.setattr(jnative, "_tried", False)
            if jnative.get_lib() is not None:
                break
        if time.monotonic() > deadline:
            mp.setattr(native, "_lib", None)
            mp.setattr(native, "_tried", True)
            break
        time.sleep(0.5)
    return jnative.available() and native.available()
