"""train_mfu (%): ``readers.mfu`` over the training iterations of the
cells that report ``train_img_per_s``."""

from perfbench.lib.readers import mfu as read  # noqa: F401
