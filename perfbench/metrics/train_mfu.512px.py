"""train_mfu.512px (%): ``readers.mfu`` over the training iterations of
the cells that report ``train_img_per_s.512px``."""

from perfbench.lib.readers import mfu as read  # noqa: F401
