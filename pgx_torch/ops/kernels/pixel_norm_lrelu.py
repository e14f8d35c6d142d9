"""Kernel B: pixel-norm + leaky-ReLU with no bias (the generator's input
layer, after the latent -> 4x4 projection).

Replaces ``pgx/ops/pallas/kernels.py:pixel_norm_lrelu_pallas`` (body
``_pn_lrelu_kernel``): ``x * rsqrt(mean_c(x^2) + eps)`` then lrelu(slope),
the mean over the true C.  Statistics are taken in f32 (f64 for f64).

Bound: bytes (one read and one write of x).  It shares kernel A's source
(``csrc/epilogue.cu``: one warp per row, the row held in registers) with the
bias pointer left null, and keeps its own entry and launch count.

``supported(x)`` is kernel A's rule (float32 or bfloat16, C a multiple of 8
and at most 512): the generator asks it before calling ``pixel_norm_lrelu``.

Differentiable like kernel A: an ``autograd.Function`` whose forward
calls the op ``torch.ops.pgx_torch.pixel_norm_lrelu`` (the kernel for a
CUDA tensor, the plain version for a CPU tensor; ``build.define_op``) and whose backward is plain torch ops on the saved
input (the generator's input layer sits under grad in the G step).
"""

from __future__ import annotations

import torch

from pgx_torch.ops.kernels import build
# supported: kernel A's rule is kernel B's, re-exported for the generator
from pgx_torch.ops.kernels.epilogue import (  # noqa: F401
    check_channels, rownorm_lrelu_backward, rownorm_lrelu_ref, stat_dtype,
    supported)

NAME = "pixel_norm_lrelu"


def pixel_norm_lrelu_ref(x: torch.Tensor, slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version, statistics in f32 (f64 for an f64 input)."""
    return rownorm_lrelu_ref(x.to(stat_dtype(x.dtype)), slope, eps, x.dtype)


def _launch(x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
    x = build.aligned(x)
    build.check_cuda_input(NAME, x)
    c = x.shape[-1]
    check_channels(NAME, c)
    out = torch.empty_like(x)
    lib = build.load_library()
    build.check(lib.pgx_pixel_norm_lrelu(
        x.data_ptr(), out.data_ptr(), x.numel() // c, c, build.dtype_code(x),
        float(slope), float(eps), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


op = build.define_op(
    f"{NAME}(Tensor x, float slope, float eps) -> Tensor",
    cpu=lambda x, slope, eps: pixel_norm_lrelu_ref(x, slope, eps),
    cuda=lambda x, slope, eps: _launch(x, slope, eps),
    fake=lambda x, slope, eps: x.new_empty(x.shape))


class _PixelNormLrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, eps):
        ctx.save_for_backward(x)
        ctx.slope, ctx.eps = slope, eps
        return op(x, slope, eps)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        acc = stat_dtype(x.dtype)
        dx = rownorm_lrelu_backward(x.to(acc), g.to(acc), ctx.slope, ctx.eps)
        return dx.to(x.dtype), None, None


def pixel_norm_lrelu(x: torch.Tensor, slope: float = 0.2,
                     eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(x), slope)`` over the last axis of NHWC ``x``,
    differentiable in ``x``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16, contiguous, C a multiple of 8 and at most 512:
    ``supported``; a misaligned view is copied first)."""
    return _PixelNormLrelu.apply(x, slope, eps)
