"""Kernel A: the conv-block epilogue bias -> pixel-norm -> leaky-ReLU.

Replaces ``pgx/ops/pallas/epilogue.py:bias_pixelnorm_lrelu`` (``_forward``,
body ``_fwd_kernel``).  Per NHWC row of C channels::

    a   = y + b                      (in y's dtype)
    r   = rsqrt(mean_c(a^2) + eps)   (f32)
    out = lrelu(a * r, slope)        (f32, stored in y's dtype)

Bound: bytes (read y once, write out once; a few operations per element).
The CUDA kernel (``csrc/epilogue.cu``) gives each row to one warp, keeps the
row in registers between the reduction and the store, and so moves exactly
those bytes.  Forward only: the differentiable form comes with training.
"""

from __future__ import annotations

import torch

from pgx_torch.ops.kernels import build

NAME = "bias_pixelnorm_lrelu"


def bias_pixelnorm_lrelu_ref(y: torch.Tensor, b: torch.Tensor,
                             slope: float = 0.2,
                             eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic, statistics in f32."""
    a = (y + b.to(y.dtype)).float()
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True)
                    * (1.0 / y.shape[-1]) + eps)
    out = a * r
    return torch.where(out < 0, slope * out, out).to(y.dtype)


def bias_pixelnorm_lrelu(y: torch.Tensor, b: torch.Tensor,
                         slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(y + b), slope)`` over the last axis of NHWC ``y``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes float32/bfloat16, contiguous, with C a multiple of 8 and at
    most 512."""
    build.forbid_autograd(NAME, y, b)
    if y.device.type == "cpu":
        return bias_pixelnorm_lrelu_ref(y, b, slope, eps)
    build.check_cuda_input(NAME, y)
    c = y.shape[-1]
    if b.shape != (c,):
        raise ValueError(f"{NAME}: bias shape {tuple(b.shape)} != ({c},)")
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
