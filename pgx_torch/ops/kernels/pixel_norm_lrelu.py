"""Kernel B: pixel-norm + leaky-ReLU with no bias (the generator's input
layer, after the latent -> 4x4 projection).

Replaces ``pgx/ops/pallas/kernels.py:pixel_norm_lrelu_pallas`` (body
``_pn_lrelu_kernel``): ``x * rsqrt(mean_c(x^2) + eps)`` then lrelu(slope),
the mean over the true C.  Statistics are taken in f32.

Bound: bytes (one read and one write of x).  It shares kernel A's source
(``csrc/epilogue.cu``: one warp per row, the row held in registers) with the
bias pointer left null, and keeps its own entry and launch count.
"""

from __future__ import annotations

import torch

from pgx_torch.ops.kernels import build

NAME = "pixel_norm_lrelu"


def pixel_norm_lrelu_ref(x: torch.Tensor, slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version, statistics in f32."""
    a = x.float()
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True)
                    * (1.0 / x.shape[-1]) + eps)
    out = a * r
    return torch.where(out < 0, slope * out, out).to(x.dtype)


def pixel_norm_lrelu(x: torch.Tensor, slope: float = 0.2,
                     eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(x), slope)`` over the last axis of NHWC ``x``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16, contiguous, C a multiple of 8 and at most 512)."""
    build.forbid_autograd(NAME, x)
    if x.device.type == "cpu":
        return pixel_norm_lrelu_ref(x, slope, eps)
    build.check_cuda_input(NAME, x)
    c = x.shape[-1]
    if c % 8 or c > 512:
        raise ValueError(f"{NAME}: C={c} must be a multiple of 8, <= 512")
    out = torch.empty_like(x)
    lib = build.load_library()
    build.check(lib.pgx_pixel_norm_lrelu(
        x.data_ptr(), out.data_ptr(), x.numel() // c, c, build.dtype_code(x),
        float(slope), float(eps), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out
