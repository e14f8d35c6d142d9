"""The control's precision: float8 e4m3 operands.

The configurations state bfloat16 compute; the nearest precision below is
float8.  ``fp8`` rounds a tensor to e4m3 under one scale per tensor (its
largest magnitude maps to e4m3's largest finite value, 448), as float8
training recipes scale, and returns it in its own dtype.  The rounding is a
constant of the graph (a straight-through estimate), so gradients of any
order flow as through the identity.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    raw = t.detach()
    scale = E4M3_MAX / raw.abs().amax().clamp_min(1e-30)
    q = (raw * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - raw)
