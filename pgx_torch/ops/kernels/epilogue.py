"""Kernel A: the conv-block epilogue bias -> pixel-norm -> leaky-ReLU.

Replaces ``pgx/ops/pallas/epilogue.py:bias_pixelnorm_lrelu`` (``_forward``,
body ``_fwd_kernel``).  Per NHWC row of C channels::

    a   = y + b                      (in y's dtype)
    r   = rsqrt(mean_c(a^2) + eps)   (f32, or wider for an f64 input)
    out = lrelu(a * r, slope)        (stored in y's dtype)

Bound: bytes (read y once, write out once; a few operations per element).
The CUDA kernel (``csrc/epilogue.cu``) gives each row to one warp, keeps the
row in registers between the reduction and the store, and so moves exactly
those bytes.

Differentiation.  The wrapper is a ``torch.autograd.Function`` whose forward
launches the kernel and whose backward is the transpose of pgx's tangent
rule (``epilogue.py:_jvp_rule``), written in plain differentiable torch ops
on the saved inputs::

    dpn = g * (a >= 0 ? 1 : slope)
    da  = r * dpn - r^3 * mean_c(dpn * a) * a
    dy  = da,  db = sum_rows(da)

It is deliberately not ``once_differentiable``: the discriminator runs this
epilogue under the WGAN-GP gradient penalty, where
``torch.autograd.grad(..., create_graph=True)`` records the backward's own
ops and differentiates them again.  pgx has no backward kernel here either
(its rule is plain jnp).
"""

from __future__ import annotations

from typing import Optional

import torch

from pgx_torch.ops.kernels import build

NAME = "bias_pixelnorm_lrelu"


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the row statistics are taken in: f32, or wider."""
    return torch.promote_types(dtype, torch.float32)


def rownorm_lrelu_ref(a: torch.Tensor, slope: float, eps: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """``lrelu(a * rsqrt(mean_c(a^2) + eps))`` for ``a`` already in the
    statistics dtype; shared by the plain versions of kernels A and B."""
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True)
                    * (1.0 / a.shape[-1]) + eps)
    out = a * r
    return torch.where(out < 0, slope * out, out).to(out_dtype)


def rownorm_lrelu_backward(a: torch.Tensor, g: torch.Tensor, slope: float,
                           eps: float) -> torch.Tensor:
    """Gradient of ``rownorm_lrelu_ref`` with respect to ``a`` for the
    cotangent ``g``, both in the statistics dtype.  Plain torch ops, so
    autograd can differentiate it again."""
    inv_c = 1.0 / a.shape[-1]
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True) * inv_c + eps)
    dpn = torch.where(a >= 0, g, slope * g)
    m = torch.sum(dpn * a, dim=-1, keepdim=True) * inv_c
    return dpn * r - a * (r * r * r) * m


def bias_pixelnorm_lrelu_ref(y: torch.Tensor, b: torch.Tensor,
                             slope: float = 0.2,
                             eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic, statistics in f32 (f64
    for an f64 input)."""
    a = (y + b.to(y.dtype)).to(stat_dtype(y.dtype))
    return rownorm_lrelu_ref(a, slope, eps, y.dtype)


def _launch(y: torch.Tensor, b: torch.Tensor, slope: float,
            eps: float) -> torch.Tensor:
    build.check_cuda_input(NAME, y)
    c = y.shape[-1]
    if c % 8 or c > 512:
        raise ValueError(f"{NAME}: C={c} must be a multiple of 8, <= 512")
    bb = b.to(device=y.device, dtype=y.dtype).contiguous()
    out = torch.empty_like(y)
    lib = build.load_library()
    build.check(lib.pgx_bias_pixelnorm_lrelu(
        y.data_ptr(), bb.data_ptr(), out.data_ptr(), y.numel() // c, c,
        build.dtype_code(y), float(slope), float(eps), build.stream_ptr()),
        NAME)
    build.LAUNCHES[NAME] += 1
    return out


class _BiasPixelNormLrelu(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor).  Backward:
    plain ops on the saved inputs, differentiable again."""

    @staticmethod
    def forward(ctx, y, b, slope, eps):
        ctx.save_for_backward(y, b)
        ctx.slope, ctx.eps = slope, eps
        if y.device.type == "cpu":
            return bias_pixelnorm_lrelu_ref(y, b, slope, eps)
        return _launch(y, b, slope, eps)

    @staticmethod
    def backward(ctx, g):
        y, b = ctx.saved_tensors
        acc = stat_dtype(y.dtype)
        a = (y + b.to(y.dtype)).to(acc)
        da = rownorm_lrelu_backward(a, g.to(acc), ctx.slope, ctx.eps)
        dy = da.to(y.dtype) if ctx.needs_input_grad[0] else None
        db: Optional[torch.Tensor] = None
        if ctx.needs_input_grad[1]:
            db = da.reshape(-1, da.shape[-1]).sum(0).to(b.dtype)
        return dy, db, None, None


def bias_pixelnorm_lrelu(y: torch.Tensor, b: torch.Tensor,
                         slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(y + b), slope)`` over the last axis of NHWC ``y``,
    differentiable to second order in ``y`` and ``b``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes float32/bfloat16, contiguous, with C a multiple of 8 and at
    most 512."""
    if b.shape != (y.shape[-1],):
        raise ValueError(f"{NAME}: bias shape {tuple(b.shape)} != "
                         f"({y.shape[-1]},)")
    return _BiasPixelNormLrelu.apply(y, b, slope, eps)
