"""Bilinear grid sampling, NHWC (counterpart of ``pgx/ops/grid_sample.py``).

Semantics of ``F.grid_sample(input, grid, mode='bilinear',
padding_mode='zeros', align_corners=False)`` with NHWC input and a grid
``(B, Hg, Wg, 2)`` of normalized (x, y) coordinates in [-1, 1].  Like pgx it
is written with four indexed reads, outside any kernel: the pixel
coordinates are taken in the grid's dtype and only the interpolation
weights are cast to the image's, so a bf16 or f64 image is sampled at the
same f32 coordinates as in pgx.  Autograd differentiates it in ``x`` to
any order.
"""

from __future__ import annotations

import torch


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    gx = (grid[..., 0] + 1.0) * (w * 0.5) - 0.5   # align_corners=False
    gy = (grid[..., 1] + 1.0) * (h * 0.5) - 0.5

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    tx = gx - x0
    ty = gy - y0
    batch_idx = torch.arange(b, device=x.device).reshape(b, 1, 1)

    def tap(ix, iy):
        # zero padding: mask out-of-range taps
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ix_c = ix.clamp(0, w - 1).to(torch.int64)
        iy_c = iy.clamp(0, h - 1).to(torch.int64)
        vals = x[batch_idx, iy_c, ix_c]               # (B, Hg, Wg, C)
        return vals * valid[..., None].to(x.dtype)

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)

    tx = tx[..., None].to(x.dtype)
    ty = ty[..., None].to(x.dtype)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def affine_grid(theta: torch.Tensor, size,
                align_corners: bool = False) -> torch.Tensor:
    """``torch.nn.functional.affine_grid`` for NHWC: ``theta`` (B, 2, 3)
    maps output normalized coordinates to input normalized coordinates;
    ``size = (B, H, W)``.  Returns (B, H, W, 2) with (x, y) last."""
    b, h, w = size
    dt, dev = theta.dtype, theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, dtype=dt, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, dtype=dt, device=dev)
    else:
        ys = (torch.arange(h, dtype=dt, device=dev) * 2 + 1) / h - 1.0
        xs = (torch.arange(w, dtype=dt, device=dev) * 2 + 1) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (H, W, 3)
    return torch.einsum("bij,hwj->bhwi", theta, coords)
