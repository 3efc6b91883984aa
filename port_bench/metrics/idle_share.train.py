"""``idle_share.train``: see :func:`port_bench.readers.idle_share`."""

from port_bench.readers import idle_share as read  # noqa: F401
