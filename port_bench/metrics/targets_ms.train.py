"""``targets_ms.train``: see :func:`port_bench.readers.targets_ms`."""

from port_bench.readers import targets_ms as read  # noqa: F401
