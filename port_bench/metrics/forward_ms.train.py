"""``forward_ms.train``: see :func:`port_bench.readers.forward_ms`."""

from port_bench.readers import forward_ms as read  # noqa: F401
