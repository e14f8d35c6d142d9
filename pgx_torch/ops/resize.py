"""Bilinear 2x up- and downsampling with exact ``F.interpolate`` parity,
NHWC.

Counterpart of ``pgx/ops/resize.py``.  With half-pixel centres the source
coordinate of output pixel ``i`` is ``i/2 - 0.25``; with edge clamping that
is an edge pad of 1 followed by a fixed 2-tap filter, interleaved::

    out[2j]   = 0.25*p[j]   + 0.75*p[j+1]
    out[2j+1] = 0.75*p[j+1] + 0.25*p[j+2]       (p = edge-padded input)

applied separably along H and W.  ``pgx`` writes these taps out because
XLA fuses them; here one ``F.interpolate`` call computes the same filter in
one pass over memory instead of one per tap, and in bf16 rounds once
instead of after every tap.  tests/test_torch_layers.py holds it against
``pgx``'s tap-by-tap form and against the taps of ``UP_FIR``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pgx_torch.parallel.collectives import halo_exchange

# The bilinear 2x upsample as a zero-stuffing FIR: F4 = [1,3,3,1]/4, i.e.
# the interleaved (0.25, 0.75) / (0.75, 0.25) phase taps above.
UP_FIR = (0.25, 0.75, 0.75, 0.25)


def upsample2x(x: torch.Tensor, rows=None) -> torch.Tensor:
    """Exact ``F.interpolate(x, scale_factor=2, mode='bilinear',
    align_corners=False)``, NHWC in and out.

    ``rows`` (a ``tp.Mesh2D`` whose model group splits H; None for whole
    images): ``x`` is this rank's rows and so is the result.  The tile gets a halo of one row that
    repeats the edge row at the true image edges (the clamp the whole
    image's filter applies there) and the neighbour's row inside; its
    interior output rows are then the whole image's, and the halo's own
    output rows are cropped."""
    if rows is None:
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                          mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1).contiguous()
    h = x.shape[1]
    y = upsample2x(halo_exchange(x, rows, 1, "edge"))
    return y[:, 2:2 * h + 2].contiguous()


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """Exact ``F.interpolate(x, scale_factor=0.5, mode='bilinear',
    align_corners=False)`` for even sizes: the 2x2 sum times 0.25, taken in
    ``x``'s dtype.  NHWC in and out; odd sizes raise.  On a rank's rows of
    an image split over H it is exact as long as the rank holds an even
    number of rows (no 2x2 block crosses the cut): the discriminator
    gathers a rank's single row first."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"downsample2x needs even H and W, got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.sum(dim=(2, 4), dtype=x.dtype) * 0.25


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling: identical to ``downsample2x``."""
    return downsample2x(x)
