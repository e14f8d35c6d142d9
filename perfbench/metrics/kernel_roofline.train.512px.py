"""kernel_roofline.train.512px (%): ``readers.kernel_roofline`` in the
cells that report ``train_img_per_s.512px``."""

from perfbench.lib.readers import kernel_roofline as read  # noqa: F401
