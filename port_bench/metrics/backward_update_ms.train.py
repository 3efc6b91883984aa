"""``backward_update_ms.train``: see :func:`port_bench.readers.backward_update_ms`."""

from port_bench.readers import backward_update_ms as read  # noqa: F401
