"""``kernel_roofline.rate``: see :func:`port_bench.readers.kernel_roofline`."""

from port_bench.readers import kernel_roofline as read  # noqa: F401
