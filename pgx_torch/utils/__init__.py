"""Host utilities of the port (counterpart of ``pgx/utils/__init__.py``):
PNG and grid writing, URLs, ``EasyDict``, the tee logger, the dnnlib.util
helpers, and the device an entry point runs on.  Named spans (pgx's
``profiled`` ranges) are ``pgx_torch.utils.trace.span``."""

from __future__ import annotations

import sys
from typing import Any

import torch

from pgx_torch.utils.png import make_grid, save_image_grid, to_uint8, write_png  # noqa: F401
from pgx_torch.utils.url import is_url, open_url  # noqa: F401


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``.  Raises when a CUDA device is asked for and none is
    present; never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class EasyDict(dict):
    """Attribute-access dict (dnnlib.util.EasyDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


class Logger:
    """Tee stdout to a log file (dnnlib.util.Logger)."""

    def __init__(self, file_name=None, mode="a", should_flush=True):
        self.file = open(file_name, mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        sys.stdout = self

    def write(self, text: str) -> None:
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        sys.stdout = self.stdout
        if self.file is not None:
            self.file.close()


# ---------------------------------------------------------------------------
# dnnlib.util helpers
# ---------------------------------------------------------------------------

def format_time(seconds) -> str:
    """Human-readable duration (dnnlib.util.format_time)."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60 * 60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return (f"{s // (24 * 60 * 60)}d {(s // (60 * 60)) % 24:02d}h "
            f"{(s // 60) % 60:02d}m")


def format_size(num_bytes: int) -> str:
    """Human-readable byte size."""
    value = float(num_bytes)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if value < 1024 or unit == "TB":
            return (f"{int(value)} {unit}" if unit == "B"
                    else f"{value:.1f} {unit}")
        value /= 1024
    raise AssertionError


def get_obj_by_name(name: str):
    """Import an object by dotted path (dnnlib.util's reflection)."""
    import importlib
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            continue
        obj = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"cannot resolve {name!r}")


def call_func_by_name(name: str, *args, **kwargs):
    """Resolve a dotted path and call it (dnnlib.util.call_func_by_name)."""
    return get_obj_by_name(name)(*args, **kwargs)


def list_dir_recursively_with_ignore(root: str, ignores=None):
    """[(abs_path, rel_path)] for all files under root, skipping ignored
    directory and file name patterns (dnnlib.util)."""
    import fnmatch
    import os
    ignores = ignores or []
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if not any(fnmatch.fnmatch(d, p) for p in ignores)]
        for name in sorted(filenames):
            if any(fnmatch.fnmatch(name, p) for p in ignores):
                continue
            abs_path = os.path.join(dirpath, name)
            out.append((abs_path, os.path.relpath(abs_path, root)))
    return out
