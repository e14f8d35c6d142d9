"""Fused multiply-add, ``a * b + c`` (counterpart of ``pgx/ops/fma.py``).

Autograd differentiates the expression through broadcasting, so the op is
the expression itself.
"""

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a * b + c
