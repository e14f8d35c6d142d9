"""cudnn_conv_ms.train.512px (ms): ``readers.conv_ms``, a training
iteration, in the cells that report ``train_img_per_s.512px``."""

from perfbench.lib.readers import conv_ms as read  # noqa: F401
