"""Tensor ops of the port: resizing, upfirdn2d, bias_act, grid_sample, the
shear warp, and the CUDA kernels (``pgx_torch.ops.kernels``)."""

from pgx_torch.ops.bias_act import activation_funcs, bias_act  # noqa: F401
from pgx_torch.ops.conv2d_resample import conv2d_resample  # noqa: F401
from pgx_torch.ops.fma import fma  # noqa: F401
from pgx_torch.ops.grid_sample import affine_grid, grid_sample  # noqa: F401
from pgx_torch.ops.resize import (  # noqa: F401
    UP_FIR,
    avg_pool2x,
    downsample2x,
    upsample2x,
)
from pgx_torch.ops.upfirdn2d import (  # noqa: F401
    downsample2d,
    filter2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
