"""Dependency-free PNG writing and sample-grid rendering.

A copy of ``pgx/utils/png.py`` (numpy + zlib), kept here so that the port
imports nothing of ``pgx``.

Replaces torchvision.utils.save_image(normalize=True, range=(-1,1))
(reference call: train.py:175-180) for the periodic sample grids.  Pure
stdlib (zlib) so the training loop has no image-library dependency; PIL is
only needed by dataset loaders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img: np.ndarray) -> bytes:
    """Encode an (H, W, C) uint8 array (C in {1, 3}) as PNG bytes."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    assert img.dtype == np.uint8 and c in (1, 3)
    color_type = 0 if c == 1 else 2

    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, C) uint8 array (C in {1, 3}) as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def to_uint8(images: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    """torchvision-style normalize: clamp to range, rescale to [0, 255].

    uint8 input passes through unchanged (already quantized — e.g. by the
    on-device path, ``make_eval_generate(output='uint8')``)."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        return images
    lo, hi = value_range
    x = np.clip(np.asarray(images, np.float32), lo, hi)
    x = (x - lo) / (hi - lo)
    return (x * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 10, padding: int = 2,
              value_range=(-1.0, 1.0)) -> np.ndarray:
    """Tile a batch (B, H, W, C) into one uint8 grid image, nrow per row."""
    x = to_uint8(images, value_range)
    b, h, w, c = x.shape
    ncol = (b + nrow - 1) // nrow
    grid = np.zeros((ncol * (h + padding) + padding,
                     nrow * (w + padding) + padding, c), np.uint8)
    for idx in range(b):
        r, col = divmod(idx, nrow)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = x[idx]
    return grid


def save_image_grid(path: str, images, nrow: int = 10,
                    value_range=(-1.0, 1.0)) -> None:
    """Save a batch of NHWC images in [-1, 1] as one PNG grid
    (the reference's 5x10 / CxC sample grids, train.py:171-180)."""
    write_png(path, make_grid(np.asarray(images), nrow=nrow,
                              value_range=value_range))
