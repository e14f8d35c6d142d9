"""kernel_roofline.train (%): ``readers.kernel_roofline`` in the cells
that report ``train_img_per_s``."""

from perfbench.lib.readers import kernel_roofline as read  # noqa: F401
