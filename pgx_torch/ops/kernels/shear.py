"""Kernel F: per-line fractional shift, the shear passes of the ADA warp.

Replaces ``pgx/ops/pallas/shear.py:shift_1d_pallas``; the contract is
``pgx.ops.warp._shift_1d_jnp``.  ``img`` is ``[B, C, R, N]``; ``axis=3``
shifts along N with one shift per (B, R) line (``shift`` ``[B, R]``),
``axis=2`` shifts along R with one shift per (B, N) column (``shift``
``[B, N]``).  With L the shifted extent::

    s = clip(shift, -(L+2), L+2);  k = floor(s);  f = s - k
    out[x] = (1-f) * in[x+k]   * [0 <= x+k < L]
           +   f   * in[x+k+1] * [-1 <= x+k < L-1]

Linear interpolation with zero fill.  The blend is taken in f32 (f64 for an
f64 image) and rounded once, as pgx's Pallas kernel does.

Bound: bytes, one read and one write of the tensor.  The CUDA kernel
(``csrc/shear.cu``) reads the two taps by index; it has no rotation ladder,
no padding of R and no transposed route for large extents.

Differentiation.  The op is linear in ``img`` and its transpose is the
shift by ``-shift``, so the Function's backward applies the Function itself
(on a card: launches the same kernel) and therefore differentiates again.
``shift`` gets no gradient: in the augmentation pipe it derives from random
draws only.
"""

from __future__ import annotations

import torch

from pgx_torch.ops.kernels import build

NAME = "shift_1d"


def _check_shapes(img: torch.Tensor, shift: torch.Tensor, axis: int) -> None:
    if axis not in (2, 3):
        raise ValueError(f"{NAME}: axis must be 2 or 3, got {axis}")
    if img.ndim != 4:
        raise ValueError(f"{NAME}: img must be [B, C, R, N], got "
                         f"{tuple(img.shape)}")
    b, _, r, n = img.shape
    want = (b, r) if axis == 3 else (b, n)
    if tuple(shift.shape) != want:
        raise ValueError(f"{NAME}: shift shape {tuple(shift.shape)} != "
                         f"{want} for axis {axis}")


def shift_1d_ref(img: torch.Tensor, shift: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Plain PyTorch version: the two taps read by an index along ``axis``,
    masked where they fall outside the extent; no modulo anywhere."""
    _check_shapes(img, shift, axis)
    length = img.shape[axis]
    acc = torch.promote_types(img.dtype, torch.float32)
    s = torch.clamp(shift.to(torch.float32), -(length + 2.0), length + 2.0)
    k = torch.floor(s)
    frac = s - k
    # [B, R] -> [B, 1, R, 1] for axis 3; [B, N] -> [B, 1, 1, N] for axis 2
    expand = ((lambda v: v[:, None, :, None]) if axis == 3
              else (lambda v: v[:, None, None, :]))
    pos_shape = [1, 1, 1, 1]
    pos_shape[axis] = length
    src = (torch.arange(length, device=img.device).reshape(pos_shape)
           + expand(k.to(torch.int64)))
    v0 = (src >= 0) & (src < length)
    v1 = (src >= -1) & (src < length - 1)
    x = img.to(acc)
    g0 = torch.take_along_dim(
        x, src.clamp(0, length - 1).expand(x.shape), dim=axis)
    g1 = torch.take_along_dim(
        x, (src + 1).clamp(0, length - 1).expand(x.shape), dim=axis)
    frac = expand(frac).to(acc)
    zero = torch.zeros((), dtype=acc, device=img.device)
    out = ((1.0 - frac) * torch.where(v0, g0, zero)
           + frac * torch.where(v1, g1, zero))
    return out.to(img.dtype)


def _launch(img: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    build.check_cuda_input(NAME, img)
    b, c, r, n = img.shape
    sh = shift.to(device=img.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(img)
    lib = build.load_library()
    build.check(lib.pgx_shift_1d(
        img.data_ptr(), sh.data_ptr(), out.data_ptr(), b, c, r, n, axis,
        build.dtype_code(img), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


class _Shift1d(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor).  Backward:
    the same Function with the shift negated."""

    @staticmethod
    def forward(ctx, img, shift, axis):
        ctx.save_for_backward(shift)
        ctx.axis = axis
        if img.device.type == "cpu":
            return shift_1d_ref(img, shift, axis)
        return _launch(img, shift, axis)

    @staticmethod
    def backward(ctx, g):
        shift, = ctx.saved_tensors
        return _Shift1d.apply(g.contiguous(), -shift, ctx.axis), None, None


def shift_1d(img: torch.Tensor, shift: torch.Tensor,
             axis: int) -> torch.Tensor:
    """``out[x] = in[x + shift(line)]`` along ``axis`` of ``img[B,C,R,N]``
    with linear interpolation and zero fill, differentiable in ``img`` to
    any order; ``shift`` is detached.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16; made contiguous first)."""
    _check_shapes(img, shift, axis)
    return _Shift1d.apply(img.contiguous(), shift.detach(), axis)
