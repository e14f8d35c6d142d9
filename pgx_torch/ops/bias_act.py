"""Fused bias + activation + gain + clamp with the nine-activation registry.

Counterpart of ``pgx/ops/bias_act.py``.  With the bias along the last axis
(NHWC) the op goes to kernel E (``pgx_torch.ops.kernels.bias_act``): a CUDA
tensor launches it or raises, a CPU tensor takes its plain version.  Any
other ``dim`` takes the plain chain of torch ops, as pgx takes its lax
chain.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgx_torch.ops.kernels.bias_act import (  # noqa: F401
    ActivationSpec,
    activation_funcs,
    bias_act_channel_last,
    bias_act_ref,
    resolve,
)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             dim: int = -1, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """``y = clamp(gain * act(x + broadcast(b, dim)))``; ``dim`` is the
    channel axis of ``b`` in ``x`` (default -1 for NHWC).  ``alpha`` and
    ``gain`` default to the activation's registry values."""
    if dim in (-1, x.ndim - 1):
        _, alpha_, gain_, clamp_ = resolve(act, alpha, gain, clamp)
        return bias_act_channel_last(x, b, act, alpha_, gain_, clamp_)
    return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
