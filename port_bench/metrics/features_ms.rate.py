"""``features_ms.rate``: see :func:`port_bench.readers.features_ms`."""

from port_bench.readers import features_ms as read  # noqa: F401
