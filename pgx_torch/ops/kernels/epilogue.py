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
launches the kernel.  Its backward is a second Function,
``_BiasPixelNormLreluGrad``, whose forward launches the backward kernel
(``pgx_bias_pixelnorm_lrelu_bwd``; the plain version for a CPU tensor): the
transpose of pgx's tangent rule (``epilogue.py:_jvp_rule``)::

    s   = lrelu's slope at a,   dpn = s * g
    da  = r * dpn - r^3 * mean_c(dpn * a) * a
    dy  = da,  db = sum_rows(da)

Neither is ``once_differentiable``: the discriminator runs this epilogue
under the WGAN-GP gradient penalty, where ``torch.autograd.grad(...,
create_graph=True)`` records the backward and differentiates it again.  The
second derivative is written out in closed form in plain differentiable
torch ops (``rownorm_lrelu_backward_vjp``), which the penalty's outer pass
runs in place of autograd through the first derivative's ops.  pgx has no
backward kernel (its rule is plain jnp).
"""

from __future__ import annotations

from typing import Optional

import torch

from pgx_torch.ops.kernels import build

NAME = "bias_pixelnorm_lrelu"
NAME_BWD = "bias_pixelnorm_lrelu_bwd"


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


def rownorm_lrelu_backward_vjp(a: torch.Tensor, g: torch.Tensor,
                               u: torch.Tensor, slope: float, eps: float):
    """The second derivative in closed form: for the cotangent ``u`` of
    ``rownorm_lrelu_backward(a, g)``, its gradients ``(d_a, d_g)``.  All in
    the statistics dtype; plain torch ops, differentiable again.  Per row,
    with P = sum(u * dpn), Q = sum(u * a)::

        d_g = s * (r u - r^3 Q a / C)
        d_a = (3 r^5 m Q / C - r^3 P / C) a - r^3 Q dpn / C - r^3 m u
    """
    inv_c = 1.0 / a.shape[-1]
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True) * inv_c + eps)
    pos = a >= 0
    # tensors on both sides of torch.where: a Python scalar there is f32
    dpn = torch.where(pos, g, g * slope)
    m = torch.sum(dpn * a, dim=-1, keepdim=True) * inv_c
    p = torch.sum(u * dpn, dim=-1, keepdim=True) * inv_c
    q = torch.sum(u * a, dim=-1, keepdim=True) * inv_c
    r3 = r * r * r
    r3q = r3 * q
    # per-row coefficients first: each full-size term is one fused pass
    t = torch.addcmul(r * u, a, r3q, value=-1.0)
    d_g = torch.where(pos, t, t * slope)
    d_a = torch.addcmul((3.0 * r3 * r * r * m * q - r3 * p) * a, dpn, r3q,
                        value=-1.0)
    d_a = torch.addcmul(d_a, u, r3 * m, value=-1.0)
    return d_a, d_g


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


def bias_pixelnorm_lrelu_backward_ref(y: torch.Tensor, b: torch.Tensor,
                                      g: torch.Tensor, slope: float = 0.2,
                                      eps: float = 1e-8):
    """Plain version of the backward kernel: ``(dy, db)`` of
    ``bias_pixelnorm_lrelu`` for the cotangent ``g``, in y's and b's
    dtypes, statistics and the ``db`` sum in f32 (f64 for f64)."""
    acc = stat_dtype(y.dtype)
    a = (y + b.to(y.dtype)).to(acc)
    da = rownorm_lrelu_backward(a, g.to(acc), slope, eps)
    return (da.to(y.dtype),
            da.reshape(-1, da.shape[-1]).sum(0).to(b.dtype))


def _launch_backward(y: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     slope: float, eps: float):
    build.check_cuda_input(NAME_BWD, y)
    c = y.shape[-1]
    if c % 8 or c > 512:
        raise ValueError(f"{NAME_BWD}: C={c} must be a multiple of 8, "
                         f"<= 512")
    if g.shape != y.shape:
        raise ValueError(f"{NAME_BWD}: cotangent shape {tuple(g.shape)} != "
                         f"{tuple(y.shape)}")
    bb = b.to(device=y.device, dtype=y.dtype).contiguous()
    gg = g.to(dtype=y.dtype).contiguous()
    rows = y.numel() // c
    lib = build.load_library()
    dy = torch.empty_like(y)
    # f32 column sums of each block; the kernel leaves db in row 0
    part = torch.empty((max(lib.pgx_bias_pixelnorm_lrelu_bwd_blocks(rows), 1),
                        c), dtype=torch.float32, device=y.device)
    if rows == 0:
        part.zero_()
    build.check(lib.pgx_bias_pixelnorm_lrelu_bwd(
        y.data_ptr(), bb.data_ptr(), gg.data_ptr(), dy.data_ptr(),
        part.data_ptr(), rows, c, build.dtype_code(y), float(slope),
        float(eps), build.stream_ptr()), NAME_BWD)
    build.LAUNCHES[NAME_BWD] += 1
    return dy, part[0].to(b.dtype)


class _BiasPixelNormLrelu(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor).  Backward:
    ``_BiasPixelNormLreluGrad``, differentiable again."""

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
        dy, db = _BiasPixelNormLreluGrad.apply(y, b, g, ctx.slope, ctx.eps)
        return (dy if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None)


class _BiasPixelNormLreluGrad(torch.autograd.Function):
    """``(dy, db)`` for the cotangent g.  Forward: the backward kernel (the
    plain version for a CPU tensor).  Backward: the second derivative in
    closed form, plain differentiable ops."""

    @staticmethod
    def forward(ctx, y, b, g, slope, eps):
        ctx.save_for_backward(y, b, g)
        ctx.slope, ctx.eps = slope, eps
        ctx.set_materialize_grads(False)
        if y.device.type == "cpu":
            return bias_pixelnorm_lrelu_backward_ref(y, b, g, slope, eps)
        return _launch_backward(y, b, g, slope, eps)

    @staticmethod
    def backward(ctx, ddy, ddb):
        y, b, g = ctx.saved_tensors
        if ddy is None and ddb is None:
            return None, None, None, None, None
        acc = stat_dtype(y.dtype)
        # dy and db are the same da (db summed over rows): one cotangent
        u = ddy.to(acc) if ddy is not None else torch.zeros((), dtype=acc,
                                                              device=y.device)
        if ddb is not None:
            u = u + ddb.to(acc)
        u = u.expand(y.shape)
        a = (y + b.to(y.dtype)).to(acc)
        d_a, d_g = rownorm_lrelu_backward_vjp(a, g.to(acc), u, ctx.slope,
                                              ctx.eps)
        d_y = d_a.to(y.dtype) if ctx.needs_input_grad[0] else None
        d_b: Optional[torch.Tensor] = None
        if ctx.needs_input_grad[1]:
            d_b = d_a.reshape(-1, d_a.shape[-1]).sum(0).to(b.dtype)
        d_g = d_g.to(g.dtype) if ctx.needs_input_grad[2] else None
        return d_y, d_b, d_g, None, None


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
