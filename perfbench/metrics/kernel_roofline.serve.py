"""kernel_roofline.serve (%): ``readers.kernel_roofline`` in the serving
cells."""

from perfbench.lib.readers import kernel_roofline as read  # noqa: F401
