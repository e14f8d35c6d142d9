"""``conv2d`` whose double backward runs on cuDNN's own kernels.

pgx leaves its convolutions and all their derivatives to XLA.  PyTorch's
``F.conv2d`` is cuDNN's for the forward and the first backward, but its
double backward (``aten::_convolution_double_backward``) computes the
weight gradient of the input-gradient term as a convolution with batch and
channels swapped, i.e. with a kernel as large as the image; cuDNN has no
tensor-core kernel for that and drops to a generic one.  The WGAN-GP
penalty differentiates the discriminator's input gradient with respect to
the weights, so every conv of the discriminator takes that path once per
iteration: measured on an H100 it was the largest single cost of a
training iteration.

This is the fix the PyTorch GAN code bases use (StyleGAN2-ADA's
``conv2d_gradfix``): the conv is an ``autograd.Function`` whose backward is
written in forward ops — the input gradient as a transposed convolution,
the weight gradient as a second Function — so differentiating the backward
again only ever asks cuDNN for forward, data-gradient and weight-gradient
kernels.  Stride 1, dilation 1, one group, as the models use; ``padding``
an int or an ``(h, w)`` pair (spatial mode's haloed tiles pad W alone).

``needs_input_grad`` of a Python Function says whether an input requires
grad at all, not whether this backward call needs it; so the penalty's
inner ``autograd.grad`` with respect to the image also computes each conv's
weight gradient, which nothing reads.

Forward mode (the JVP form of the penalty): the tangent of ``conv2d(x, w)``
is ``conv2d(tx, w) + conv2d(x, tw)``, computed by this same conv, so the
dual forward stays on cuDNN's forward kernels and reverse mode over it
needs first-order conv gradients only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _weight_gradient(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     padding: int) -> torch.Tensor:
    """cuDNN's weight gradient of ``conv2d(x, w, padding)`` for the output
    cotangent ``gy`` (``w`` gives the shape only)."""
    pad = [padding, padding] if isinstance(padding, int) else list(padding)
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, [1, 1], pad, [1, 1], False, [0, 0],
        1, [False, True, False])[1]


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.save_for_forward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, padding=padding)

    @staticmethod
    def jvp(ctx, tx, tw, _tpad):
        x, w = ctx.saved_tensors
        out = None if tx is None else conv2d(tx, w, ctx.padding)
        if tw is not None:
            tw_out = conv2d(x, tw, ctx.padding)
            out = tw_out if out is None else out + tw_out
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = F.conv_transpose2d(gy, w, padding=ctx.padding)
        if ctx.needs_input_grad[1]:
            gw = _Conv2dGradWeight.apply(gy, x, w, ctx.padding)
        return gx, gw, None


class _Conv2dGradWeight(torch.autograd.Function):
    """``(gy, x) -> dL/dw``, bilinear in its two inputs; its own backward is
    a conv and a transposed conv."""

    @staticmethod
    def forward(ctx, gy, x, w, padding):
        ctx.save_for_backward(gy, x)
        ctx.padding = padding
        return _weight_gradient(gy, x, w, padding)

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        ggy = gx = None
        if ctx.needs_input_grad[0]:
            ggy = conv2d(x, ggw, ctx.padding)
        if ctx.needs_input_grad[1]:
            gx = F.conv_transpose2d(gy, ggw, padding=ctx.padding)
        return ggy, gx, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, padding=0) -> torch.Tensor:
    """``F.conv2d(x, w, padding=padding)`` for NCHW ``x`` (any memory
    format) and OIHW ``w``, differentiable to second order through cuDNN's
    forward, data-gradient and weight-gradient kernels."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv2d.apply(x, w, padding)
    return F.conv2d(x, w, padding=padding)
