"""Kernel C: 3x3 SAME conv fused with bias -> pixel-norm -> leaky-ReLU.

Replaces ``pgx/ops/pallas/conv_epilogue.py:conv3x3_epilogue_fwd`` (body
``_kernel``, both variants of its one ``pallas_call``) and the
differentiable op ``make_conv3x3_epilogue`` around it:
``y = lrelu(pixel_norm(conv3x3_same(x, w) + b))`` in one pass, the conv
accumulated in f32 and the pixel-norm statistics taken in f32.

Bound: operations at the 16-32 px stages (C = 512), bytes at 4-8 px where the
weights outweigh the activations.  The CUDA kernel (``csrc/conv_epilogue.cu``)
is an implicit GEMM in which a CTA (for C_out = 512 a cluster of two, which
split the channels) owns a tile of 128 output pixels and every output
channel, because the pixel norm reduces over all of C_out; the epilogue
runs on the accumulators, so the pre-activation never reaches device
memory.  bf16 runs on Hopper's warpgroup MMA (wgmma) fed by TMA loads of the
NHWC tensor itself (the copy's zero fill is the SAME padding; in a cluster
the pixel tile is multicast to both CTAs), in persistent CTAs; f32 runs on
CUDA-core FMA.

Two ops, ``torch.ops.pgx_torch.conv3x3_epilogue`` and
``conv3x3_epilogue_r`` (``build.define_op``): the kernel's launch for CUDA
tensors, the plain version for CPU tensors.

Two launches, counted apart.  Without grad the plain entry runs
(``conv3x3_epilogue``).  Under grad with pixel-norm the residual-emitting
entry runs (``conv3x3_epilogue_r``): the same kernel also writes the scale
``r = rsqrt(mean_c(a^2) + eps)`` as (B, H, W, 1) f32, 1/C_out the size of
the activation.  The backward rebuilds everything else from the output
(the leaky-ReLU is inverted from ``y``), then takes the two gradient convs
from cuDNN, as pgx takes them from XLA.  The op is differentiable once
only: a backward under ``create_graph=True`` raises, so it must never sit
in the discriminator under the gradient penalty.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels import build
from pgx_torch.ops.kernels.epilogue import stat_dtype

NAME = "conv3x3_epilogue"
NAME_R = "conv3x3_epilogue_r"


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel takes NHWC ``x`` and the HWIO kernel ``w``: float32
    or bfloat16, a 3x3 ``w`` whose C_in is x's, C_in a multiple of 8 and
    C_out a multiple of 8 and at most 512."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        return False
    cin, cout = x.shape[-1], w.shape[3]
    return (x.dtype in (torch.float32, torch.bfloat16) and w.shape[2] == cin
            and cin > 0 and cin % 8 == 0 and 0 < cout <= 512
            and cout % 8 == 0)


def conv3x3_epilogue_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         *, use_pixel_norm: bool = True, slope: float = 0.2,
                         eps: float = 1e-8, return_r: bool = False):
    """Plain PyTorch version (``conv3x3_epilogue_ref`` of the Pallas
    module): conv and bias in x's dtype, pixel-norm statistics in f32 (f64
    for f64).  ``w`` is the pre-scaled HWIO kernel, x and the result NHWC.
    ``return_r`` (pixel-norm only) also returns the scale r, (B, H, W, 1)
    in the statistics dtype: the plain version of the residual-emitting
    entry."""
    if return_r and not use_pixel_norm:
        raise ValueError("r is only defined for the pixel-norm variant")
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.to(x.dtype)
    r = None
    if use_pixel_norm:
        yf = y.to(stat_dtype(y.dtype))
        r = torch.rsqrt(torch.sum(yf * yf, dim=-1, keepdim=True)
                        / y.shape[-1] + eps)
        y = (yf * r).to(x.dtype)
    y = torch.where(y >= 0, y, slope * y).contiguous()
    return (y, r) if return_r else y


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            use_pixel_norm: bool, slope: float, eps: float, emit_r: bool):
    """Check the inputs, lay the weights out for the kernel and launch the
    plain entry or, with ``emit_r``, the residual-emitting one."""
    name = NAME_R if emit_r else NAME
    x = build.aligned(x)
    build.check_cuda_input(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got shape {tuple(x.shape)}")
    nb, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: w shape {tuple(w.shape)} is not "
                         f"(3, 3, {cin}, C_out)")
    cout = w.shape[3]
    if b.shape != (cout,):
        raise ValueError(f"{name}: bias shape {tuple(b.shape)} != ({cout},)")
    if cin % 8 or cout % 8 or cout > 512:
        raise ValueError(f"{name}: C_in={cin}, C_out={cout} must be "
                         f"multiples of 8 with C_out <= 512")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{name}: x, w and b must share one device")
    lib = build.load_library()
    if x.dtype == torch.bfloat16:
        # [9][C_out_pad][C_in]: K-major tiles for wgmma, by 2-D TMA
        cpad = lib.pgx_conv3x3_cout_pad(cout)
        wk = w.to(x.dtype).permute(0, 1, 3, 2).reshape(9, cout, cin)
        wk = F.pad(wk, (0, 0, 0, cpad - cout)).contiguous()
    else:
        wk = w.to(x.dtype).reshape(9, cin, cout).contiguous()
    bb = build.aligned(b.to(x.dtype).contiguous())
    out = torch.empty((nb, h, wd, cout), dtype=x.dtype, device=x.device)
    if emit_r:
        r = torch.empty((nb, h, wd, 1), dtype=torch.float32, device=x.device)
        build.check(lib.pgx_conv3x3_epilogue_r(
            x.data_ptr(), wk.data_ptr(), bb.data_ptr(), out.data_ptr(),
            r.data_ptr(), nb, h, wd, cin, cout, build.dtype_code(x),
            float(slope), float(eps), build.stream_ptr()), name)
        build.LAUNCHES[name] += 1
        return out, r
    build.check(lib.pgx_conv3x3_epilogue(
        x.data_ptr(), wk.data_ptr(), bb.data_ptr(), out.data_ptr(), nb, h, wd,
        cin, cout, build.dtype_code(x), int(use_pixel_norm), float(slope),
        float(eps), build.stream_ptr()), name)
    build.LAUNCHES[name] += 1
    return out


def _out_fake(x, w):
    return x.new_empty((*x.shape[:3], w.shape[3]))


op = build.define_op(
    f"{NAME}(Tensor x, Tensor w, Tensor b, bool use_pixel_norm, "
    f"float slope, float eps) -> Tensor",
    cpu=lambda x, w, b, use_pixel_norm, slope, eps: conv3x3_epilogue_ref(
        x, w, b, use_pixel_norm=use_pixel_norm, slope=slope, eps=eps),
    cuda=lambda x, w, b, use_pixel_norm, slope, eps: _launch(
        x, w, b, use_pixel_norm, slope, eps, emit_r=False),
    fake=lambda x, w, b, use_pixel_norm, slope, eps: _out_fake(x, w))
op_r = build.define_op(
    f"{NAME_R}(Tensor x, Tensor w, Tensor b, float slope, float eps) "
    f"-> (Tensor, Tensor)",
    cpu=lambda x, w, b, slope, eps: conv3x3_epilogue_ref(
        x, w, b, slope=slope, eps=eps, return_r=True),
    cuda=lambda x, w, b, slope, eps: _launch(x, w, b, True, slope, eps,
                                             emit_r=True),
    fake=lambda x, w, b, slope, eps: (
        _out_fake(x, w),
        x.new_empty((*x.shape[:3], 1), dtype=stat_dtype(x.dtype))))


def _no_graph(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              use_pixel_norm: bool, slope: float, eps: float) -> torch.Tensor:
    """The output alone, no graph: the plain entry's op."""
    with torch.no_grad():
        return op(x, w, b, use_pixel_norm, slope, eps)


def conv3x3_epilogue_with_r(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, *, slope: float = 0.2,
                            eps: float = 1e-8):
    """``(y, r)``: the pixel-norm variant's output and its scale residual,
    (B, H, W, 1) f32 — pgx's ``conv3x3_epilogue_fwd(..., emit_r=True)``.
    No autograd graph is recorded.  Through the residual-emitting entry's
    op: CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    with torch.no_grad():
        return op_r(x, w, b, slope, eps)


class _Conv3x3Epilogue(torch.autograd.Function):
    """The differentiated forward and its VJP
    (``make_conv3x3_epilogue``'s ``op_fwd`` / ``op_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, b, use_pixel_norm, slope, eps):
        if use_pixel_norm:
            y, r = conv3x3_epilogue_with_r(x, w, b, slope=slope, eps=eps)
        else:   # the backward needs no residual: lrelu inverts from y alone
            y, r = _no_graph(x, w, b, False, slope, eps), None
        ctx.save_for_backward(x, w, b, y, r)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        # Grad mode is on in a backward only when the caller asked for a
        # graph of it (create_graph=True).  Refusing here catches every
        # double backward, also the one whose cotangent carries no graph,
        # which torch's ``once_differentiable`` would let through as a
        # constant.
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{NAME} is differentiable once only (its backward inverts "
                f"the epilogue from the output and is not itself "
                f"differentiable): it cannot run under create_graph=True, "
                f"e.g. in a discriminator under the gradient penalty")
        x, w, b, y, r = ctx.saved_tensors
        acc = stat_dtype(y.dtype)
        c = y.shape[-1]
        # invert the epilogue from its own output: v = y / lrelu'(y); y == 0
        # takes the positive branch, as the forward does
        lr_slope = torch.full_like(y, ctx.slope, dtype=acc).masked_fill_(
            y >= 0, 1.0)
        v = y.to(acc) / lr_slope
        dv = g.to(acc) * lr_slope
        if r is not None:
            # u = v / r;  du = r * (dv - v <dv, v> / c)
            du = r * (dv - v * (torch.sum(dv * v, dim=-1, keepdim=True) / c))
        else:
            du = dv
        du = du.to(x.dtype)
        db = None
        if ctx.needs_input_grad[2]:
            db = du.to(acc).sum(dim=(0, 1, 2)).to(b.dtype)
        # the data and weight gradients of the bare conv: cuDNN's
        dx, dw, _ = torch.ops.aten.convolution_backward(
            du.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            w.to(x.dtype).permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            dx = dx.permute(0, 2, 3, 1)
        if dw is not None:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        return dx, dw, db, None, None, None


def conv3x3_epilogue(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     use_pixel_norm: bool = True, slope: float = 0.2,
                     eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(conv3x3_same(x, w) + b))`` for NHWC ``x`` and the
    pre-scaled HWIO kernel ``w`` (3, 3, C_in, C_out), differentiable to
    first order in x, w and b.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16 x, contiguous; C_in and C_out multiples of 8,
    C_out <= 512: ``supported``; a misaligned view is copied first): the
    plain entry when no gradient is recorded, the residual-emitting entry
    under grad."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _Conv3x3Epilogue.apply(x, w, b, use_pixel_norm, slope, eps)
    return _no_graph(x, w, b, use_pixel_norm, slope, eps)
