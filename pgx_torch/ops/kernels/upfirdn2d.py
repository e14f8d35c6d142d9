"""Kernel D: separable upfirdn2d (pad or crop, zero-stuff by ``up``, 1-D
FIR, decimate by ``down``) on NHWC tensors.

Replaces ``pgx/ops/pallas/kernels.py:upfirdn2d_pallas``.  Per axis, with
``taps`` the filter scaled by ``sqrt(gain)`` and flipped unless
``flip_filter`` (a true convolution by default)::

    out[j] = sum_t taps[t] * d[j*down + t - pad0]
    d[p]   = x[p/up] where p >= 0, p % up == 0 and p/up < L, else 0
    n_out  = (L*up + pad0 + pad1 - ntaps) // down + 1

so the zero-stuffed signal carries the trailing ``up - 1`` zeros and
negative padding crops.  Sums are taken in f32 (f64 for an f64 input) and
rounded once per pass.

Bound: bytes.  The CUDA kernel (``csrc/upfirdn2d.cu``) is one launch per
1-D pass, along H and then along W, each thread indexing its taps in the
input directly; two launches per call.

Differentiation.  The op is linear in ``x`` and its transpose is an
upfirdn with ``up`` and ``down`` swapped, the filter flipped the other way
and the padding of the reference's backward (``p0' = ntaps - p0 - 1``,
``p1' = L*up - n_out*down + p0 - up + 1`` per axis), so the Function's
backward applies the Function itself: on a card it launches kernel D twice
more, and it differentiates again.  pgx takes the VJP of its lax
formulation instead; the gradients are the same linear map.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels import build

NAME = "upfirdn2d"
Pads = Tuple[int, int, int, int]          # (px0, px1, py0, py1)


def out_len(length: int, ntaps: int, up: int, down: int, pad0: int,
            pad1: int) -> int:
    return max((length * up + pad0 + pad1 - ntaps) // down + 1, 0)


def _oriented(taps: Sequence[float], flip_filter: bool) -> Tuple[float, ...]:
    """Taps in correlation order: flipped for a true convolution."""
    taps = tuple(float(t) for t in taps)
    return taps if flip_filter else taps[::-1]


def _pass_ref(x: torch.Tensor, taps: Tuple[float, ...], axis: int, up: int,
              down: int, pad0: int, pad1: int) -> torch.Tensor:
    """One pass along H (axis 1) or W (axis 2) of NHWC ``x`` in plain ops;
    ``taps`` in correlation order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    v = x.to(acc).movedim(axis, -1)                   # [..., L]
    if up > 1:                                        # zero-stuff
        v = torch.stack([v] + [torch.zeros_like(v)] * (up - 1), dim=-1)
        v = v.reshape(*v.shape[:-2], -1)
    v = F.pad(v, (max(pad0, 0), max(pad1, 0)))
    v = v[..., max(-pad0, 0):v.shape[-1] - max(-pad1, 0)]
    n = v.shape[-1] - len(taps) + 1
    if n <= 0:
        out = v.new_zeros(*v.shape[:-1], 0)
    else:
        k = torch.tensor(taps, dtype=acc, device=x.device)
        out = F.conv1d(v.reshape(-1, 1, v.shape[-1]), k[None, None])
        out = out.reshape(*v.shape[:-1], n)[..., ::down]
    return out.movedim(-1, axis).to(x.dtype)


def upfirdn2d_ref(x: torch.Tensor, taps: Sequence[float], up: int = 1,
                  down: int = 1, pads: Pads = (0, 0, 0, 0),
                  flip_filter: bool = False) -> torch.Tensor:
    """Plain PyTorch version: H pass then W pass with the 1-D ``taps``
    (already scaled by ``sqrt(gain)``)."""
    px0, px1, py0, py1 = pads
    t = _oriented(taps, flip_filter)
    y = _pass_ref(x, t, 1, up, down, py0, py1)
    return _pass_ref(y, t, 2, up, down, px0, px1).contiguous()


def _launch_pass(x: torch.Tensor, taps: Tuple[float, ...], axis: int,
                 up: int, down: int, pad0: int, pad1: int) -> torch.Tensor:
    b, h, w, c = x.shape
    length = x.shape[axis]
    n_out = out_len(length, len(taps), up, down, pad0, pad1)
    shape = (b, n_out, w, c) if axis == 1 else (b, h, n_out, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    outer, inner = (b, w * c) if axis == 1 else (b * h, c)
    lib = build.load_library()
    if len(taps) > lib.pgx_upfirdn_max_taps():
        raise ValueError(f"{NAME}: {len(taps)} taps, the kernel takes at "
                         f"most {lib.pgx_upfirdn_max_taps()}")
    if out.numel() == 0:
        return out
    arr = (ctypes.c_float * len(taps))(*taps)
    build.check(lib.pgx_upfirdn_1d(
        x.data_ptr(), out.data_ptr(), arr, len(taps), outer, length, n_out,
        inner, up, down, pad0, build.dtype_code(x), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


def _launch(x: torch.Tensor, taps: Sequence[float], up: int, down: int,
            pads: Pads, flip_filter: bool) -> torch.Tensor:
    build.check_cuda_input(NAME, x)
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"{NAME}: up and down must be 1 or 2, got "
                         f"{up}, {down}")
    px0, px1, py0, py1 = pads
    t = _oriented(taps, flip_filter)
    y = _launch_pass(x, t, 1, up, down, py0, py1)
    return _launch_pass(y, t, 2, up, down, px0, px1)


class _Upfirdn2d(torch.autograd.Function):
    """Forward: two launches of the kernel (the plain version for a CPU
    tensor).  Backward: the same Function as the transposed upfirdn."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pads, flip_filter):
        ctx.args = (taps, up, down, pads, flip_filter)
        ctx.in_hw = (x.shape[1], x.shape[2])
        if x.device.type == "cpu":
            return upfirdn2d_ref(x, taps, up, down, pads, flip_filter)
        return _launch(x, taps, up, down, pads, flip_filter)

    @staticmethod
    def backward(ctx, g):
        taps, up, down, (px0, px1, py0, py1), flip_filter = ctx.args
        ih, iw = ctx.in_hw
        oh, ow = g.shape[1], g.shape[2]
        n = len(taps)
        pads = (n - px0 - 1, iw * up - ow * down + px0 - up + 1,
                n - py0 - 1, ih * up - oh * down + py0 - up + 1)
        gx = _Upfirdn2d.apply(g.contiguous(), taps, down, up, pads,
                              not flip_filter)
        return gx, None, None, None, None, None


def upfirdn2d_separable(x: torch.Tensor, taps: Sequence[float], up: int = 1,
                        down: int = 1, pads: Pads = (0, 0, 0, 0),
                        flip_filter: bool = False) -> torch.Tensor:
    """Separable upfirdn2d of NHWC ``x`` with the 1-D ``taps`` (already
    scaled by ``sqrt(gain)``) applied along H and W, ``pads = (px0, px1,
    py0, py1)``; differentiable in ``x`` to any order.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16, ``up`` and ``down`` in {1, 2}; made contiguous
    first)."""
    if x.ndim != 4:
        raise ValueError(f"{NAME}: x must be NHWC, got {tuple(x.shape)}")
    taps = tuple(float(t) for t in taps)
    pads = tuple(int(p) for p in pads)
    return _Upfirdn2d.apply(x.contiguous(), taps, int(up), int(down), pads,
                            bool(flip_filter))
