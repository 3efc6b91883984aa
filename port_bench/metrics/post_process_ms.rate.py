"""``post_process_ms.rate``: see :func:`port_bench.readers.post_process_ms`."""

from port_bench.readers import post_process_ms as read  # noqa: F401
