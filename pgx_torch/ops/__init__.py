"""Tensor ops of the port: resampling and the CUDA kernels."""

from pgx_torch.ops.resize import (  # noqa: F401
    UP_FIR,
    downsample2x,
    upsample2x,
)
