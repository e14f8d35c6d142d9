"""Gather-free affine warp for the ADA geometric pipeline.

Counterpart of ``pgx/ops/warp.py``.  The reference executes its geometric
augmentations as reflect-pad -> 2x FIR upsample -> ``grid_sample`` at an
affine grid -> 2x FIR downsample.  This module computes the same operator
in passes built from banded resampling and per-line shifts:

  pass 0   reflect pad and conditional transpose blit (absorbs the
           90-degree part so the shear factors stay small; per-sample
           select)
  pass 1   the diagonal part: per-axis 1-D resampling that folds the
           reference's sym6 up-filter and the bilinear tent together,
           landing on a 2x-supersampled intermediate (the same rate the
           reference interpolates at)
  pass 2/3 the triangular (shear) parts: per-row / per-column fractional
           shifts (kernel F, ``pgx_torch.ops.kernels.shear``): exact
           zero-fill semantics
  pass 4   the reference's sym6 down-filter along both axes

Passes 0 + 1 and pass 4 are kernel W (``pgx_torch.ops.kernels.
warp_resample``: ``warp_resample`` and ``warp_down2``), which on a card
computes them as bands, reading the unpadded image and folding the pad in;
on the CPU the same ops take their plain route, pgx's arithmetic: ``F.pad``
and the einsums over the tent and filter matrices (``_tent_matrix`` x U2
for pass 1, the static D2 for pass 4), which pgx leaves to XLA.

Factorization: after an optional axis swap (image transpose), the inverse
affine ``A`` is decomposed as ``A = D(sx,sy) @ ShearX(alpha) @ ShearY(gamma)``
(pass order: leftmost factor first).  The swap is chosen per sample to
minimize ``max(|alpha|, |gamma|)``; for every pure rotation this bounds both
shears by 1.

Exactness: for transforms with no rotation component (flips, 90-degree
rotations, integer/fractional translation, iso/aniso scaling) the shear
factors are zero and this chain is algebraically identical to the reference
operator.  Rotations insert two extra 1-D tent interpolations at the
2x-supersampled rate; the gather path (``pgx_torch.ops.grid_sample``)
remains the parity oracle (``AugmentConfig.warp_impl='gather'``).

Shear extents are static: shifts are representable up to ``shear_margin``
(in units of half the output extent, default 1.0: all pure rotations);
beyond the margin samples read zeros.

Every pass is linear in the image and each kernel has its transpose, and
the transform parameters are detached, so autograd gives the exact
gradient with respect to the image, to any order.
"""

from __future__ import annotations

import numpy as np
import torch

from pgx_torch.ops.kernels.shear import shift_1d
from pgx_torch.ops.kernels.warp_resample import (
    _centered,
    warp_down2,
    warp_resample,
)


def _decompose(a_mat: torch.Tensor, t_vec: torch.Tensor):
    """Batched pivoted decomposition A_eff = D(sx,sy) Shx(alpha) Shy(gamma).

    Returns (swap, sx, sy, alpha, gamma, aa, bb, cc, dd, tx, ty) where
    ``swap`` selects the transposed-image variant (rows of A and components
    of t swapped).  The pivot picks whichever variant has the smaller max
    shear magnitude."""
    a = a_mat[:, 0, 0]
    b = a_mat[:, 0, 1]
    c = a_mat[:, 1, 0]
    d = a_mat[:, 1, 1]
    # in a's dtype (a Python scalar in torch.where is f32), filled on the
    # device
    tiny = torch.full((), 1e-8, dtype=a.dtype, device=a.device)

    def safe(x):
        return torch.where(torch.abs(x) < tiny,
                           torch.where(x < 0, -tiny, tiny), x)

    def shears(aa, bb, cc, dd):
        det = safe(aa * dd - bb * cc)
        dd = safe(dd)
        return bb * dd / det, cc / dd

    al0, ga0 = shears(a, b, c, d)
    al1, ga1 = shears(c, d, a, b)          # rows swapped (transposed image)
    swap = (torch.maximum(torch.abs(al1), torch.abs(ga1))
            < torch.maximum(torch.abs(al0), torch.abs(ga0)))
    aa = torch.where(swap, c, a)
    bb = torch.where(swap, d, b)
    cc = torch.where(swap, a, c)
    dd = torch.where(swap, b, d)
    tx = torch.where(swap, t_vec[:, 1], t_vec[:, 0])
    ty = torch.where(swap, t_vec[:, 0], t_vec[:, 1])
    det = safe(aa * dd - bb * cc)
    dd_s = safe(dd)
    sx = det / dd_s
    sy = dd
    alpha = bb * dd_s / det
    gamma = cc / dd_s
    return swap, sx, sy, alpha, gamma, aa, bb, cc, dd, tx, ty


def warp_extents(n: int, taps: int, shear_margin: float = 1.0):
    """The 2x grids of an ``n``-pixel square image and a ``taps``-tap
    filter: ``(out_n, vy, vx, my2, mx2)``, the cropped extent, the
    intermediate's rows and columns, and the two crops' offsets.  The shear
    margins are static (2x-grid pixels), with pgx's rounding of the
    intermediate extents so both packages warp on the same grids."""
    def _round_up(v, m):
        return ((v + m - 1) // m) * m

    out_n = 2 * (n + 2 * (taps // 4))
    my2 = int(np.ceil(shear_margin * out_n / 2)) + 2
    vy = _round_up(out_n + 2 * my2, 64)
    my2 = (vy - out_n) // 2
    mx2 = int(np.ceil(shear_margin * vy / 2)) + 2
    vx = _round_up(out_n + 2 * mx2, 128)
    mx2 = (vx - out_n) // 2
    return out_n, vy, vx, my2, mx2


def resample_params(a_mat: torch.Tensor, t_vec: torch.Tensor):
    """Kernel W's per-sample parameters ``[B, 5]`` (swap, sx, sy, t_x,
    t_y: the diagonal factor and the total map on the 2x grids, u = A_eff p
    + T with T = A_eff h + 2 t - h) and the two shears ``alpha``, ``gamma``
    of the pivoted decomposition, f32 and detached."""
    swap, sx, sy, alpha, gamma, aa, bb, cc, dd, tx, ty = _decompose(
        a_mat.detach().to(torch.float32), t_vec.detach().to(torch.float32))
    t_x = 0.5 * (aa + bb) + 2.0 * tx - 0.5
    t_y = 0.5 * (cc + dd) + 2.0 * ty - 0.5
    params = torch.stack([swap.to(torch.float32), sx, sy, t_x, t_y], 1)
    return params, alpha, gamma


def ada_geom_warp_shear(images: torch.Tensor, a_mat: torch.Tensor,
                        t_vec: torch.Tensor, hz, *,
                        shear_margin: float = 1.0) -> torch.Tensor:
    """Apply the ADA geometric operator to a batch.

    ``images`` [B, H, W, C] (square: H == W required), unpadded: pass 0
    reflect-pads it by the pipe's static margin ``(W - 1, H - 1)``;
    ``a_mat`` [B, 2, 2] / ``t_vec`` [B, 2] are the linear/translation parts
    of the accumulated inverse homography ``G_inv`` in original-image
    centered pixel units.  Returns [B, H, W, C]: the counterpart of reflect
    pad -> upsample2d -> grid_sample -> downsample2d in the gather path."""
    _, h, w, _ = images.shape
    if h != w:
        raise ValueError("shear warp requires square images; "
                         "use warp_impl='gather' for non-square images")
    dev = images.device
    hz_t = tuple(np.asarray(hz, np.float64).reshape(-1).tolist())
    out_n, vy, vx, my2, mx2 = warp_extents(h, len(hz_t), shear_margin)
    out_h = out_w = out_n

    params, alpha, gamma = resample_params(a_mat, t_vec)

    # passes 0 + 1: reflect pad, transpose blit, diagonal resample (sym6
    # up-filter folded in) to [B, C, Vy, Vx]: the shifts run along the
    # minor axis
    v = warp_resample(images, params, vy, vx, hz_t)

    # pass 2: x-shear, then crop to the output column window
    v = shift_1d(v, alpha[:, None] * _centered(vy, dev)[None, :], axis=3)
    v = v[:, :, :, mx2:mx2 + out_w]

    # pass 3: y-shear, then crop to the output row window
    v = shift_1d(v, gamma[:, None] * _centered(out_w, dev)[None, :], axis=2)
    v = v[:, :, my2:my2 + out_h, :]

    # pass 4: sym6 down-filter, back to NHWC
    return warp_down2(v, hz_t)
