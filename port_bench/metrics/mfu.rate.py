"""``mfu.rate``: see :func:`port_bench.readers.mfu`."""

from port_bench.readers import mfu as read  # noqa: F401
