"""2-D convolution with fused up/downsampling, NHWC activations and HWIO
weights (counterpart of ``pgx/ops/conv2d_resample.py``).

One composition of ``upfirdn2d`` and a convolution, as in pgx.  The GAN
models do not use it (they resize with the bilinear ops); it completes the
ops layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pgx_torch.ops.upfirdn2d import (_filter_array, _filter_hw,
                                     _parse_padding, upfirdn2d)


def _conv2d(x: torch.Tensor, w: torch.Tensor, groups: int = 1,
            flip_weight: bool = True) -> torch.Tensor:
    """``w`` is HWIO; ``flip_weight=True`` is ordinary cross-correlation,
    ``False`` flips the kernel (transpose-conv style).  No padding."""
    if not flip_weight:
        w = w.flip(0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """NHWC ``x``, HWIO ``w``, optional FIR ``f`` applied around the conv."""
    fh, fw = (1, 1)
    if f is not None:
        f = _filter_array(f)
        fh, fw = _filter_hw(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    x = upfirdn2d(x, f if up > 1 else None, up=up,
                  padding=(px0, px1, py0, py1), gain=up ** 2,
                  flip_filter=flip_filter)
    x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
