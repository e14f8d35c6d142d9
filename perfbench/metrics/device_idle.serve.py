"""device_idle.serve (%): ``readers.device_idle`` per image served."""

from perfbench.lib.readers import device_idle as read  # noqa: F401
