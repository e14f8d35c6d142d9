"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Counterpart of ``pgx/ops/pallas/``.  Each kernel entry is a
``torch.library`` op (``torch.ops.pgx_torch.<name>``, registered when this
package is imported): it takes the plain version for CPU tensors only and
launches the kernel for CUDA tensors; there is no switch that sends a CUDA
tensor to the plain version.  The library is built from ``csrc/`` on first
launch (``build.py``), never at import.
"""

from pgx_torch.ops.kernels.bias_act import (  # noqa: F401
    activation_funcs,
    bias_act_channel_last,
    bias_act_ref,
)
from pgx_torch.ops.kernels.build import (  # noqa: F401
    launch_counts,
    load_library,
    reset_launch_counts,
)
from pgx_torch.ops.kernels.conv_epilogue import (  # noqa: F401
    conv3x3_epilogue,
    conv3x3_epilogue_ref,
    conv3x3_epilogue_with_r,
)
from pgx_torch.ops.kernels.epilogue import (  # noqa: F401
    bias_pixelnorm_lrelu,
    bias_pixelnorm_lrelu_jvp_ref,
    bias_pixelnorm_lrelu_ref,
    bias_pixelnorm_lrelu_tangent,
)
from pgx_torch.ops.kernels.pixel_norm_lrelu import (  # noqa: F401
    pixel_norm_lrelu,
    pixel_norm_lrelu_ref,
)
from pgx_torch.ops.kernels.shear import (  # noqa: F401
    shift_1d,
    shift_1d_ref,
)
from pgx_torch.ops.kernels.upfirdn2d import (  # noqa: F401
    upfirdn2d_ref,
    upfirdn2d_separable,
)
from pgx_torch.ops.kernels.warp_resample import (  # noqa: F401
    warp_down2,
    warp_down2_ref,
    warp_down2_t_ref,
    warp_resample,
    warp_resample_ref,
    warp_resample_t_ref,
)
