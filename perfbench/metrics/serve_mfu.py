"""serve_mfu (%): ``readers.mfu`` over G's forwards for the images
returned in the window."""

from perfbench.lib.readers import mfu as read  # noqa: F401
