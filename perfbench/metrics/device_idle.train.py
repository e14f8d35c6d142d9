"""device_idle.train (%): ``readers.device_idle`` per training iteration,
in the cells that report ``train_img_per_s``."""

from perfbench.lib.readers import device_idle as read  # noqa: F401
