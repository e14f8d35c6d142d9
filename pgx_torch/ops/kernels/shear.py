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
no padding of R and no transposed route for large extents.  Axis 3 makes 16
bytes of outputs per thread from two aligned 16-byte loads.  Axis 2 stages a
band of input rows per tile of ``TILE_ROWS`` x ``STRIP`` outputs in shared
memory (``BAND_ROWS`` rows: every shift slope up to 2 per column fits; a
tile whose shifts spread wider reads device memory directly).  The input
may be a view with strided rows, such as the warp's column crop: the kernel
takes its strides and moves the widest unit (16, 8, 4 or 2 bytes) that
divides its pointer, strides and row length (``_unit``), so the crop is not
copied first.

The op ``torch.ops.pgx_torch.shift_1d`` (``build.define_op``) launches the
kernel for CUDA tensors and takes the plain version for CPU tensors; it
reads its input with the input's strides, so no copy is made in front of
it, and its output is contiguous.

Differentiation.  The op is linear in ``img`` and its transpose is the
shift by ``-shift``, so the Function's backward applies the Function itself
(on a card: launches the same kernel) and therefore differentiates again.
``shift`` gets no gradient: in the augmentation pipe it derives from random
draws only.
"""

from __future__ import annotations

import functools

import torch

from pgx_torch.ops.kernels import build

NAME = "shift_1d"
# csrc/shear.cu's axis-2 tile: columns, output rows, staged rows
STRIP, TILE_ROWS, BAND_ROWS = 32, 64, 64 + 2 * 32 + 2


def _unit(ptr: int, strides, length: int, itemsize: int) -> int:
    """The widest of 16, 8, 4 and 2 bytes (at least one element) that
    divides the byte address ``ptr``, every element stride in ``strides``
    and a row of ``length`` elements: the lowest bit set in any of them,
    capped at 16."""
    bits = ptr | 16 | length * itemsize
    for s in strides:
        bits |= s * itemsize
    return max(bits & -bits, itemsize)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, once it has shown the tile ``STRIP``,
    ``TILE_ROWS`` and ``BAND_ROWS`` describe."""
    lib = build.load_library()
    got = tuple(lib.pgx_shift_1d_tile(i) for i in range(3))
    if got != (STRIP, TILE_ROWS, BAND_ROWS):
        raise RuntimeError(f"{NAME}: csrc/shear.cu's tile {got} differs from "
                           f"shear.py's {(STRIP, TILE_ROWS, BAND_ROWS)}")
    return lib


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
    if img.stride(-1) != 1 or img.data_ptr() % 4:
        img = build.aligned(img.contiguous())
    build.check_cuda_input(NAME, img, rows_strided=True)
    b, c, r, n = img.shape
    sb, sc, sr, _ = img.stride()
    es = img.element_size()
    sh = shift.to(device=img.device, dtype=torch.float32).contiguous()
    out = torch.empty(img.shape, dtype=img.dtype, device=img.device)
    lib = _library()
    build.check(lib.pgx_shift_1d(
        img.data_ptr(), sh.data_ptr(), out.data_ptr(), b, c, r, n, sb, sc, sr,
        axis, build.dtype_code(img),
        _unit(img.data_ptr(), (sb, sc, sr), n, es), _unit(0, (), n, es),
        build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


op = build.define_op(
    f"{NAME}(Tensor img, Tensor shift, int axis) -> Tensor",
    cpu=lambda img, shift, axis: shift_1d_ref(img, shift, axis),
    cuda=lambda img, shift, axis: _launch(img, shift, axis),
    fake=lambda img, shift, axis: img.new_empty(img.shape))


class _Shift1d(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor).  Backward:
    the same Function with the shift negated."""

    @staticmethod
    def forward(ctx, img, shift, axis):
        ctx.save_for_backward(shift)
        ctx.axis = axis
        return op(img, shift, axis)

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
    (float32/bfloat16), which reads a view with strided rows in place (a
    last-axis stride other than 1, or a start not 4-byte aligned, is copied
    first); the result is contiguous."""
    _check_shapes(img, shift, axis)
    return _Shift1d.apply(img, shift.detach(), axis)
