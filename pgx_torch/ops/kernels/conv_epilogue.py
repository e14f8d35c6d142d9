"""Kernel C: 3x3 SAME conv fused with bias -> pixel-norm -> leaky-ReLU.

Replaces ``pgx/ops/pallas/conv_epilogue.py:conv3x3_epilogue_fwd`` (body
``_kernel``): ``y = lrelu(pixel_norm(conv3x3_same(x, w) + b))`` in one pass,
the conv accumulated in f32 and the pixel-norm statistics taken in f32.

Bound: operations at the 16-32 px stages (C = 512), bytes at 4-8 px where the
weights outweigh the activations.  The CUDA kernel (``csrc/conv_epilogue.cu``)
is an implicit GEMM in which one block owns a tile of output pixels and every
output channel, because the pixel norm reduces over all of C_out; the
epilogue runs on the accumulators, so the pre-activation never reaches device
memory.  bf16 runs on the tensor cores (mma.sync), f32 on CUDA-core FMA.
Forward only: the residual-emitting form and its VJP come with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels import build

NAME = "conv3x3_epilogue"


def conv3x3_epilogue_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         *, use_pixel_norm: bool = True, slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version (``conv3x3_epilogue_ref`` of the Pallas
    module): conv and bias in x's dtype, pixel-norm statistics in f32.
    ``w`` is the pre-scaled HWIO kernel, x and the result NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.to(x.dtype)
    if use_pixel_norm:
        yf = y.float()
        y = (yf * torch.rsqrt(torch.sum(yf * yf, dim=-1, keepdim=True)
                              / y.shape[-1] + eps)).to(x.dtype)
    return torch.where(y >= 0, y, slope * y).contiguous()


def conv3x3_epilogue(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     use_pixel_norm: bool = True, slope: float = 0.2,
                     eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(conv3x3_same(x, w) + b))`` for NHWC ``x`` and the
    pre-scaled HWIO kernel ``w`` (3, 3, C_in, C_out).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16 x, contiguous; C_in and C_out multiples of 8,
    C_out <= 512)."""
    build.forbid_autograd(NAME, x, w, b)
    if x.device.type == "cpu":
        return conv3x3_epilogue_ref(x, w, b, use_pixel_norm=use_pixel_norm,
                                    slope=slope, eps=eps)
    build.check_cuda_input(NAME, x)
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be NHWC, got shape {tuple(x.shape)}")
    nb, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{NAME}: w shape {tuple(w.shape)} is not "
                         f"(3, 3, {cin}, C_out)")
    cout = w.shape[3]
    if b.shape != (cout,):
        raise ValueError(f"{NAME}: bias shape {tuple(b.shape)} != ({cout},)")
    if cin % 8 or cout % 8 or cout > 512:
        raise ValueError(f"{NAME}: C_in={cin}, C_out={cout} must be "
                         f"multiples of 8 with C_out <= 512")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{NAME}: x, w and b must share one device")
    lib = build.load_library()
    if x.dtype == torch.bfloat16:
        # [9][C_out_pad][C_in]: K-contiguous for the tensor-core fragments
        cpad = lib.pgx_conv3x3_cout_pad(cout)
        wk = w.to(x.dtype).permute(0, 1, 3, 2).reshape(9, cout, cin)
        wk = F.pad(wk, (0, 0, 0, cpad - cout)).contiguous()
    else:
        wk = w.to(x.dtype).reshape(9, cin, cout).contiguous()
    bb = b.to(x.dtype).contiguous()
    out = torch.empty((nb, h, wd, cout), dtype=x.dtype, device=x.device)
    build.check(lib.pgx_conv3x3_epilogue(
        x.data_ptr(), wk.data_ptr(), bb.data_ptr(), out.data_ptr(), nb, h, wd,
        cin, cout, build.dtype_code(x), int(use_pixel_norm), float(slope),
        float(eps), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out
