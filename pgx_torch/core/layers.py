"""Equalized-learning-rate layers over NHWC tensors.

Counterpart of ``pgx/core/layers.py``.  Parameters are stored at their raw
N(0,1) initialization in ``pgx``'s layouts (conv kernels HWIO, the input
layer's transposed-conv kernel HWOI) and the He constant is applied at
forward, in f32, before the cast to the compute dtype.

fan_in follows the reference's quirk:
  * Conv2d           -> fan_in = in_ch * kh * kw
  * ConvTranspose2d  -> fan_in = out_ch * kh * kw   (quirk)
  * Linear           -> fan_in = in_features
  * Embedding        -> fan_in = embedding_dim

Dispatch mirrors ``pgx``: with ``fused=True`` (the generator) every
padding-1 3x3 conv that is not preceded by a fused upsample runs kernel C
(conv + bias + pixel-norm + lrelu in one pass); the epilogue after
``equal_conv2d_up2x`` runs kernel A when it pixel-normalizes.  As in pgx,
each kernel is taken only where its ``supported`` predicate accepts the
shape and dtype (C a multiple of 8 and at most 512, float32 or bfloat16);
elsewhere the conv is cuDNN's and the epilogue the plain torch ops below,
decided before any launch.  Kernel C is
differentiable once only, so the discriminator, which sits under the
gradient penalty's double backward, passes ``fused=False``: its convs are
cuDNN's and their epilogues kernel A, which differentiates twice.  Each
kernel wrapper takes its plain version for CPU tensors only.  cuDNN/cuBLAS
carry the work ``pgx`` leaves to XLA: the latent projection, the 1x1
to_rgb/from_rgb convs, the upsample + conv and every conv of the
discriminator.

With the train step's ``weights_cast='once'`` a layer receives a weight
already rounded to the compute dtype, and the He constant (rounded to that
dtype, as pgx multiplies by a Python scalar) is applied after the rounding.

``rows`` (a ``pgx_torch.parallel.tp.Mesh2D`` with a model axis, in spatial
mode; None for whole images): the input is this rank's rows of images split
over H across the model group, and so is the output.  A padding-1 3x3 conv takes a halo of one row from each
neighbour (``halo_exchange``): cuDNN's conv runs on the tile haloed with
zeros at the true edges and pads W alone; kernel C runs on the tile with
no rows added at the true edges (its own SAME padding stands there) and
the halo's output rows are cropped, so it sees ``H / n + 2`` rows, or
``H / n + 1`` at an edge.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from pgx_torch.ops.conv2d_gradfix import conv2d
from pgx_torch.ops.kernels import (bias_pixelnorm_lrelu, conv3x3_epilogue)
from pgx_torch.ops.kernels import conv_epilogue as kernel_c
from pgx_torch.ops.kernels import epilogue as kernel_a
from pgx_torch.ops.resize import upsample2x
from pgx_torch.parallel.collectives import (all_reduce_sum, halo_exchange,
                                            world_size)

# ---------------------------------------------------------------------------
# PixelNorm / LeakyReLU / minibatch stddev
# ---------------------------------------------------------------------------


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean_c(x^2) + eps) over the last axis, in x's dtype."""
    ssq = torch.sum(x * x, dim=-1, keepdim=True, dtype=x.dtype)
    return x * torch.rsqrt(ssq * (1.0 / x.shape[-1]) + eps)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def minibatch_stddev(x: torch.Tensor, eps: float = 1e-8, groups: int = 1,
                     group=None) -> torch.Tensor:
    """Append the minibatch-stddev feature map as one extra channel.

    Biased variance over the batch per (H, W, C) position, sqrt(var + eps),
    averaged to a scalar, broadcast to (B, H, W, 1) and concatenated.  The
    variance is computed as ``pgx``'s ``jnp.var`` computes it: in float32
    (or wider), cast back to ``x``'s type.

    ``groups > 1`` takes the statistic independently per contiguous batch
    slice of size ``B / groups``, so one forward over
    ``cat([real, fake, x_hat])`` scores each slice exactly as separate
    calls would (``TrainConfig.d_concat``).

    ``group`` (a process group) takes the statistic over the global batch
    whose rows are spread over its ranks, as ``pgx`` computes it on a
    batch-sharded mesh: the count, the sum and the squared deviations are
    each summed over the ranks (``all_reduce_sum``, differentiable to any
    order); with ``groups > 1`` per group, slice g of every rank together
    forming group g."""
    b, h, w, c = x.shape
    if b % groups:
        raise ValueError(f"batch {b} not divisible by groups={groups}")
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(groups, b // groups, h, w, c).to(acc)
    total = torch.sum(xg, dim=1)                           # (G, H, W, C)
    n = b // groups
    if group is not None:
        total = all_reduce_sum(total, group)
        n *= world_size(group)
    mu = total / n
    sq = torch.sum(torch.square(xg - mu.unsqueeze(1)), dim=1)
    if group is not None:
        sq = all_reduce_sum(sq, group)
    var = (sq / n).to(x.dtype)
    mean_std = torch.sqrt(var + eps).mean(dim=(1, 2, 3))   # (G,)
    feat = mean_std.to(x.dtype).reshape(groups, 1, 1, 1, 1).expand(
        groups, b // groups, h, w, 1).reshape(b, h, w, 1)
    return torch.cat([x, feat], dim=-1)


# ---------------------------------------------------------------------------
# Equalized conv / transposed conv / embedding
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scale_in(dtype: torch.dtype, scale: float) -> float:
    """``scale`` rounded to ``dtype``: a Python scalar multiplies an array
    in the array's own type in pgx, so a bf16 weight (``weights_cast=
    'once'``) is scaled by the bf16 constant; f32 and f64 are unchanged."""
    return float(torch.tensor(scale, dtype=dtype))


def _scaled(w: torch.Tensor, scale: float) -> torch.Tensor:
    return w * _scale_in(w.dtype, scale)


def _he_scaled(w: torch.Tensor, fan_in: int, dtype) -> torch.Tensor:
    return _scaled(w, math.sqrt(2.0 / fan_in)).to(dtype)


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor,
               padding) -> torch.Tensor:
    y = conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding)
    return y.permute(0, 2, 3, 1)


def equal_conv2d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 padding=0, bias: bool = True) -> torch.Tensor:
    """EqualConv2d over NHWC ``x`` with the raw HWIO kernel ``w``;
    ``padding`` an int or an ``(h, w)`` pair."""
    kh, kw, in_ch, _ = w.shape
    y = _conv_nhwc(x, _he_scaled(w, in_ch * kh * kw, x.dtype), padding)
    if not bias:
        return y.contiguous()   # the caller's epilogue kernel takes NHWC rows
    return (y + b.to(x.dtype)).contiguous()


def equal_conv2d_up2x(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      bias: bool = True, rows=None) -> torch.Tensor:
    """``equal_conv2d(w, b, upsample2x(x), padding=1)`` for a 3x3 kernel.

    ``pgx`` composes the upsample into a 6x6 kernel over the dilated input
    and corrects the border afterwards; both are exact forms of this
    sequence, which is computed here as written (an upsample, then one
    cuDNN conv), so no border correction is needed.  ``rows``: module
    docstring (the upsample and the conv each take their halo)."""
    kh, kw, _, _ = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError("equal_conv2d_up2x is specialized to 3x3 kernels")
    up = upsample2x(x, rows)
    if rows is not None:
        y = equal_conv2d(w, b, halo_exchange(up, rows, 1, "zero"),
                         padding=(0, 1), bias=bias)
    else:
        y = equal_conv2d(w, b, up, padding=1, bias=bias)
    return y.contiguous()


def latent_to_4x4(w: torch.Tensor, b: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """The 4x4 input layer: ConvTranspose2d(k=4, s=1, p=0) on a 1x1 input,
    i.e. one matmul z -> (4, 4, out).  ``w`` is HWOI (4, 4, out, in); its
    fan_in is out * 16 (the reference's transposed-conv quirk)."""
    kh, kw, out_ch, in_ch = w.shape
    wm = _he_scaled(w, out_ch * kh * kw, z.dtype).reshape(kh * kw * out_ch,
                                                          in_ch)
    y = (z @ wm.t()).reshape(z.shape[0], kh, kw, out_ch)
    return y + b.to(z.dtype)


def equal_linear(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """EqualLinear with the raw (in, out) weight ``w``."""
    y = x @ _he_scaled(w, w.shape[0], x.dtype)
    return y + b.to(x.dtype)


def embedding(w: torch.Tensor, labels: torch.Tensor, equalized: bool = False,
              dtype=torch.float32) -> torch.Tensor:
    """Label embedding lookup; ``equalized`` applies sqrt(2 / dim)."""
    if equalized:
        w = _scaled(w, math.sqrt(2.0 / w.shape[1]))
    return w[labels.long()].to(dtype)


class EqualConv2d(nn.Module):
    """Raw HWIO kernel ``w`` ~ N(0,1) and bias ``b``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(kernel, kernel, in_ch, out_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))


class EqualConvTranspose2d(nn.Module):
    """Raw HWOI kernel ``w`` (out, in trailing) and bias ``b``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(kernel, kernel, out_ch, in_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))


class EqualLinear(nn.Module):
    """Raw (in, out) weight ``w`` ~ N(0,1) and bias ``b``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(num_embeddings, dim))


# ---------------------------------------------------------------------------
# Conv blocks
# ---------------------------------------------------------------------------


def conv_epilogue(y: torch.Tensor, b: torch.Tensor, use_pixel_norm: bool,
                  slope: float = 0.2) -> torch.Tensor:
    """bias -> PixelNorm? -> LeakyReLU on a pre-bias conv output; kernel A
    where it pixel-normalizes and takes the shape."""
    if use_pixel_norm and kernel_a.supported(y):
        return bias_pixelnorm_lrelu(y, b, slope)
    y = y + b.to(y.dtype)
    if use_pixel_norm:
        y = pixel_norm(y)
    return leaky_relu(y, slope)


def _conv_step(conv: EqualConv2d, x: torch.Tensor, padding: int,
               use_pixel_norm: bool, slope: float,
               fused: bool = True, rows=None) -> torch.Tensor:
    """One conv + epilogue.  ``fused``: kernel C for a padding-1 3x3 conv
    that it takes (where pgx's ``_maybe_fused_conv_step`` applies).
    Otherwise, and for every other conv, cuDNN's conv then the epilogue
    (kernel A), which is the only form that may sit under a double
    backward.  ``rows``: module docstring (padding-1 3x3 convs only)."""
    kh, kw, in_ch, _ = conv.w.shape
    if rows is not None and (padding != 1 or (kh, kw) != (3, 3)):
        raise ValueError(f"a {kh}x{kw} conv with padding {padding} does not "
                         f"run on rows split over H")
    if rows is not None:
        if fused and kernel_c.supported(x, conv.w):
            h, top = x.shape[1], int(rows.m > 0)
            tile = halo_exchange(x, rows, 1, "none")
            w = _scaled(conv.w, math.sqrt(2.0 / (in_ch * kh * kw)))
            out = conv3x3_epilogue(tile, w, conv.b,
                                   use_pixel_norm=use_pixel_norm,
                                   slope=slope)
            return out[:, top:top + h].contiguous()
        y = equal_conv2d(conv.w, conv.b, halo_exchange(x, rows, 1, "zero"),
                         padding=(0, 1), bias=False)
        return conv_epilogue(y, conv.b, use_pixel_norm, slope)
    if (fused and padding == 1 and (kh, kw) == (3, 3)
            and kernel_c.supported(x, conv.w)):
        w = _scaled(conv.w, math.sqrt(2.0 / (in_ch * kh * kw)))
        return conv3x3_epilogue(x, w, conv.b, use_pixel_norm=use_pixel_norm,
                                slope=slope)
    y = equal_conv2d(conv.w, conv.b, x, padding=padding, bias=False)
    return conv_epilogue(y, conv.b, use_pixel_norm, slope)


class ConvBlock(nn.Module):
    """[EqualConv2d -> PixelNorm? -> LeakyReLU] x2."""

    def __init__(self, in_ch: int, out_ch: int, kernel1: int = 3,
                 kernel2: Optional[int] = None):
        super().__init__()
        kernel2 = kernel1 if kernel2 is None else kernel2
        self.conv1 = EqualConv2d(in_ch, out_ch, kernel1)
        self.conv2 = EqualConv2d(out_ch, out_ch, kernel2)


class SingleConvBlock(nn.Module):
    """EqualConv2d -> PixelNorm? -> LeakyReLU (the mnist blocks and the
    proper arch's 4x4 block)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv1 = EqualConv2d(in_ch, out_ch, kernel)


def conv_block(p: ConvBlock, x: torch.Tensor, padding1: int = 1,
               padding2: Optional[int] = None, use_pixel_norm: bool = True,
               slope: float = 0.2, upsample_first: bool = False,
               fused: bool = True, rows=None) -> torch.Tensor:
    """``upsample_first`` runs a bilinear upsample2x before conv1 — the
    caller passes the LOW-res input.  ``fused=False`` keeps kernel C out
    (see ``_conv_step``).  ``rows``: module docstring."""
    padding2 = padding1 if padding2 is None else padding2
    if upsample_first:
        x = equal_conv2d_up2x(p.conv1.w, p.conv1.b, x, bias=False,
                              rows=rows)
        x = conv_epilogue(x, p.conv1.b, use_pixel_norm, slope)
    else:
        x = _conv_step(p.conv1, x, padding1, use_pixel_norm, slope, fused,
                       rows)
    return _conv_step(p.conv2, x, padding2, use_pixel_norm, slope, fused,
                      rows)


def single_conv_block(p: SingleConvBlock, x: torch.Tensor, padding: int = 1,
                      use_pixel_norm: bool = True, slope: float = 0.2,
                      upsample_first: bool = False,
                      fused: bool = True, rows=None) -> torch.Tensor:
    if upsample_first:
        x = equal_conv2d_up2x(p.conv1.w, p.conv1.b, x, bias=False,
                              rows=rows)
        return conv_epilogue(x, p.conv1.b, use_pixel_norm, slope)
    return _conv_step(p.conv1, x, padding, use_pixel_norm, slope, fused,
                      rows)
