"""Tensor ops of the port: resampling and the CUDA kernels."""

from pgx_torch.ops.resize import UP_FIR, upsample2x  # noqa: F401
