"""device_idle.train.512px (%): ``readers.device_idle`` per training
iteration, in the cells that report ``train_img_per_s.512px``."""

from perfbench.lib.readers import device_idle as read  # noqa: F401
