"""Gather-free affine warp for the ADA geometric pipeline.

Counterpart of ``pgx/ops/warp.py``.  The reference executes its geometric
augmentations as reflect-pad -> 2x FIR upsample -> ``grid_sample`` at an
affine grid -> 2x FIR downsample.  This module computes the same operator
in passes built from batched matrix products and per-line shifts:

  pass 0   conditional transpose blit (absorbs the 90-degree part so the
           shear factors stay small; per-sample boolean select)
  pass 1   the diagonal part: per-axis 1-D resampling matrices that fold the
           reference's sym6 up-filter and the bilinear tent together, applied
           as two batched matmuls, landing on a 2x-supersampled intermediate
           (the same rate the reference interpolates at)
  pass 2/3 the triangular (shear) parts: per-row / per-column fractional
           shifts (kernel F, ``pgx_torch.ops.kernels.shear``): exact
           zero-fill semantics
  pass 4   the reference's sym6 down-filter as two static matmuls

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

The matrix products of passes 1 and 4 are ``torch.einsum`` outside any
kernel, as pgx leaves them to XLA; f32 products run at full precision
(torch's default for matmuls, TF32 off).  Every pass is linear in the image,
and the transform parameters are detached, so autograd gives the exact
gradient with respect to the image.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pgx_torch.ops.kernels.shear import shift_1d


def upfirdn_matrix_1d(n_in: int, f, up: int = 1, down: int = 1,
                      pad0: int = 0, pad1: int = 0,
                      flip_filter: bool = False) -> np.ndarray:
    """Dense matrix of one separable upfirdn pass (numpy, static),
    including the filter flip and the trailing ``up - 1`` zero-stuffing
    pad.  Returns [n_out, n_in] float64."""
    f = np.asarray(f, np.float64).reshape(-1)
    if not flip_filter:
        f = f[::-1]
    pad1 = pad1 + (up - 1)
    dil_len = (n_in - 1) * up + 1
    total = dil_len + pad0 + pad1
    n_out = (total - len(f)) // down + 1
    m = np.zeros((n_out, n_in))
    ks = np.arange(len(f))
    for o in range(n_out):
        pos = o * down + ks - pad0
        sel = (pos >= 0) & (pos < dil_len) & (pos % up == 0)
        m[o, pos[sel] // up] += f[sel]
    return m


@functools.lru_cache(maxsize=None)
def _static_matrices(n_pad: int, n_img: int, hz: Tuple[float, ...]):
    """(U2 [2*n_pad, n_pad], D2 [n_img, out_n]) for one axis, as numpy f32.

    U2 reproduces ``upsample2d(x, hz, up=2)`` (gain 4, so sqrt-gain 2 per
    axis); D2 reproduces ``downsample2d(x, hz, down=2, padding=-2*hz_pad,
    flip_filter=True)``: the calls the gather path of the pipe makes."""
    f = np.asarray(hz, np.float64)
    fw = f.shape[0]
    hz_pad = fw // 4
    up_m = upfirdn_matrix_1d(n_pad, f * 2.0, up=2, down=1,
                             pad0=(fw + 1) // 2, pad1=(fw - 2) // 2,
                             flip_filter=False)
    out_n = 2 * (n_img + 2 * hz_pad)
    dn_m = upfirdn_matrix_1d(out_n, f, up=1, down=2,
                             pad0=-2 * hz_pad + (fw - 1) // 2,
                             pad1=-2 * hz_pad + (fw - 2) // 2,
                             flip_filter=True)
    assert up_m.shape == (2 * n_pad, n_pad)
    assert dn_m.shape == (n_img, out_n), dn_m.shape
    return up_m.astype(np.float32), dn_m.astype(np.float32)


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


def _centered(n: int, device=None) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device)
            - (n / 2 - 0.5))


def _tent_matrix(u: torch.Tensor, n_src: int) -> torch.Tensor:
    """[B, M, n_src] bilinear-interpolation matrix at coords ``u`` [B, M]
    (source pixels at centered coordinates, zero outside)."""
    kc = _centered(n_src, u.device)
    return torch.clamp_min(
        1.0 - torch.abs(u[:, :, None] - kc[None, None, :]), 0.0)


def ada_geom_warp_shear(padded: torch.Tensor, a_mat: torch.Tensor,
                        t_vec: torch.Tensor, img_hw: Tuple[int, int],
                        hz, *, shear_margin: float = 1.0) -> torch.Tensor:
    """Apply the ADA geometric operator to a reflect-padded batch.

    ``padded`` [B, Hp, Wp, C] (square: Hp == Wp required); ``a_mat``
    [B, 2, 2] / ``t_vec`` [B, 2] are the linear/translation parts of the
    accumulated inverse homography ``G_inv`` in original-image centered
    pixel units.  Returns [B, H, W, C]: the counterpart of upsample2d ->
    grid_sample -> downsample2d in the gather path."""
    b, hp, wp, c = padded.shape
    h, w = img_hw
    if hp != wp:
        raise ValueError("shear warp requires square padded input; "
                         "use warp_impl='gather' for non-square images")
    dev = padded.device
    hz_t = tuple(np.asarray(hz, np.float64).reshape(-1).tolist())
    fw = len(hz_t)
    hz_pad = fw // 4
    out_h, out_w = 2 * (h + 2 * hz_pad), 2 * (w + 2 * hz_pad)
    u2_np, d2x_np = _static_matrices(wp, w, hz_t)
    _, d2y_np = _static_matrices(hp, h, hz_t)
    u2 = torch.from_numpy(u2_np).to(dev)

    # static shear margins (in 2x-grid pixels), with pgx's rounding of the
    # intermediate extents so both packages warp on the same grids
    def _round_up(v, m):
        return ((v + m - 1) // m) * m

    my2 = int(np.ceil(shear_margin * out_w / 2)) + 2
    vy = _round_up(out_h + 2 * my2, 64)
    my2 = (vy - out_h) // 2
    mx2 = int(np.ceil(shear_margin * vy / 2)) + 2
    vx = _round_up(out_w + 2 * mx2, 128)
    mx2 = (vx - out_w) // 2

    swap, sx, sy, alpha, gamma, aa, bb, cc, dd, tx, ty = _decompose(
        a_mat.detach().to(torch.float32), t_vec.detach().to(torch.float32))

    # pass 0: conditional transpose blit
    padded = torch.where(swap[:, None, None, None],
                         padded.transpose(1, 2), padded)

    # total map on the 2x grids: u = A_eff p + T,  T = A_eff h + 2 t - h
    t_x = 0.5 * (aa + bb) + 2.0 * tx - 0.5
    t_y = 0.5 * (cc + dd) + 2.0 * ty - 0.5

    # pass 1: diagonal resample (sym6 up-filter folded in), 2x intermediate
    ux = sx[:, None] * _centered(vx, dev)[None, :] + t_x[:, None]  # [B, Vx]
    uy = sy[:, None] * _centered(vy, dev)[None, :] + t_y[:, None]  # [B, Vy]
    mx_mat = torch.einsum("bmk,kw->bmw", _tent_matrix(ux, 2 * wp), u2)
    my_mat = torch.einsum("bmk,kh->bmh", _tent_matrix(uy, 2 * hp), u2)
    dt = padded.dtype
    v = torch.einsum("bmw,bhwc->bhmc", mx_mat.to(dt), padded)  # [B,Hp,Vx,C]
    # land in [B, C, Vy, Vx]: the shifts run along the minor axis
    v = torch.einsum("bnh,bhmc->bcnm", my_mat.to(dt), v)       # [B,C,Vy,Vx]

    # pass 2: x-shear, then crop to the output column window
    v = shift_1d(v, alpha[:, None] * _centered(vy, dev)[None, :], axis=3)
    v = v[:, :, :, mx2:mx2 + out_w]

    # pass 3: y-shear, then crop to the output row window
    v = shift_1d(v, gamma[:, None] * _centered(out_w, dev)[None, :], axis=2)
    v = v[:, :, my2:my2 + out_h, :]

    # pass 4: sym6 down-filter (static matrices), back to NHWC
    d2y = torch.from_numpy(d2y_np).to(device=dev, dtype=dt)
    d2x = torch.from_numpy(d2x_np).to(device=dev, dtype=dt)
    v = torch.einsum("hm,bcmw->bchw", d2y, v)
    return torch.einsum("wn,bchn->bhwc", d2x, v)
