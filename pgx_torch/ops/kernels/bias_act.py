"""Kernel E: fused bias + activation + gain + clamp over the channel (last)
axis, with the nine-activation registry.

Replaces ``pgx/ops/pallas/kernels.py:bias_act_pallas``; the registry is
the one of ``pgx/ops/bias_act.py`` (names, default alphas and gains)::

    y = clamp(gain * act(x + b), -clamp, clamp)       (clamp < 0: none)

Bound: bytes, one read and one write of ``x``.  The CUDA kernel
(``csrc/bias_act.cu``) is one elementwise pass with 16-byte loads, the
activation picked by an integer code, arithmetic in f32, one rounding.

The op ``torch.ops.pgx_torch.bias_act`` (``build.define_op``) launches the
kernel for CUDA tensors and takes the plain version for CPU tensors.

Differentiation.  pgx's kernel has no gradient rule; its plain chain
differentiates to any order.  Here the Function's forward launches the
kernel and its backward is written in plain torch ops from each
activation's derivative (``ActivationSpec.dfunc``), so autograd can
differentiate it again: first- and second-order gradients equal autograd
through the plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from pgx_torch.ops.kernels import build

NAME = "bias_act"

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable          # (x, alpha) -> act(x)
    dfunc: Callable         # (x, alpha) -> act'(x), in plain differentiable ops
    def_alpha: float
    def_gain: float
    code: int               # the CUDA kernel's activation code


def _step(x: torch.Tensor, pos, neg) -> torch.Tensor:
    """``pos`` where x >= 0 else ``neg``, both built in x's dtype (a Python
    scalar in ``torch.where`` would be f32)."""
    return torch.where(x >= 0, torch.as_tensor(pos, dtype=x.dtype,
                                               device=x.device),
                       torch.as_tensor(neg, dtype=x.dtype, device=x.device))


def _sig(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


activation_funcs: Dict[str, ActivationSpec] = {
    "linear": ActivationSpec(
        lambda x, a: x, lambda x, a: torch.ones_like(x), 0.0, 1.0, 0),
    "relu": ActivationSpec(
        lambda x, a: torch.clamp_min(x, 0.0),
        lambda x, a: (x > 0).to(x.dtype), 0.0, math.sqrt(2.0), 1),
    "lrelu": ActivationSpec(
        lambda x, a: torch.where(x >= 0, x, a * x),
        lambda x, a: _step(x, 1.0, a), 0.2, math.sqrt(2.0), 2),
    "tanh": ActivationSpec(
        lambda x, a: torch.tanh(x),
        lambda x, a: 1.0 - torch.tanh(x) ** 2, 0.0, 1.0, 3),
    "sigmoid": ActivationSpec(
        lambda x, a: _sig(x),
        lambda x, a: _sig(x) * (1.0 - _sig(x)), 0.0, 1.0, 4),
    "elu": ActivationSpec(
        lambda x, a: torch.where(x >= 0, x, torch.exp(x) - 1.0),
        lambda x, a: torch.where(x >= 0, torch.ones_like(x), torch.exp(x)),
        0.0, 1.0, 5),
    "selu": ActivationSpec(
        lambda x, a: _SELU_SCALE * torch.where(
            x >= 0, x, _SELU_ALPHA * (torch.exp(x) - 1.0)),
        lambda x, a: _SELU_SCALE * torch.where(
            x >= 0, torch.ones_like(x), _SELU_ALPHA * torch.exp(x)),
        0.0, 1.0, 6),
    "softplus": ActivationSpec(
        lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
        lambda x, a: _sig(x), 0.0, 1.0, 7),
    "swish": ActivationSpec(
        lambda x, a: x / (1.0 + torch.exp(-x)),
        lambda x, a: _sig(x) * (1.0 + x * (1.0 - _sig(x))), 0.0,
        math.sqrt(2.0), 8),
}


def resolve(act: str, alpha: Optional[float], gain: Optional[float],
            clamp: Optional[float]):
    """The registry's defaults filled in; ``clamp`` < 0 means none."""
    spec = activation_funcs[act]
    if clamp is not None and clamp < 0:
        raise ValueError(f"{NAME}: clamp must be None or >= 0, got {clamp}")
    return (spec, float(spec.def_alpha if alpha is None else alpha),
            float(spec.def_gain if gain is None else gain),
            float(clamp) if clamp is not None else -1.0)


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _bias_shape(x: torch.Tensor, dim: int):
    shape = [1] * x.ndim
    shape[dim] = -1
    return shape


def bias_act_ref(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                 dim: int = -1, act: str = "linear",
                 alpha: Optional[float] = None, gain: Optional[float] = None,
                 clamp: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the same chain in f32 (f64 for an f64 input),
    rounded once; ``dim`` is the axis of ``x`` that ``b`` runs along."""
    spec, alpha, gain, clamp = resolve(act, alpha, gain, clamp)
    t = x.to(_acc(x))
    if b is not None:
        t = t + b.to(x.dtype).to(t.dtype).reshape(_bias_shape(x, dim))
    y = spec.func(t, alpha)
    if gain != 1.0:
        y = y * gain
    if clamp >= 0:
        y = torch.clamp(y, -clamp, clamp)
    return y.to(x.dtype)


def _launch(x: torch.Tensor, b: Optional[torch.Tensor], spec: ActivationSpec,
            alpha: float, gain: float, clamp: float) -> torch.Tensor:
    x = build.aligned(x)
    build.check_cuda_input(NAME, x)
    c = x.shape[-1]
    bb = None
    if b is not None:
        bb = build.aligned(
            b.to(device=x.device, dtype=x.dtype).contiguous())
    out = torch.empty_like(x)
    lib = build.load_library()
    build.check(lib.pgx_bias_act(
        x.data_ptr(), None if bb is None else bb.data_ptr(), out.data_ptr(),
        x.numel(), c, spec.code, alpha, gain, clamp, build.dtype_code(x),
        build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


op = build.define_op(
    f"{NAME}(Tensor x, Tensor? b, str act, float alpha, float gain, "
    f"float clamp) -> Tensor",
    cpu=lambda x, b, act, alpha, gain, clamp: bias_act_ref(
        x, b, -1, act, alpha, gain, clamp if clamp >= 0 else None),
    cuda=lambda x, b, act, alpha, gain, clamp: _launch(
        x, b, activation_funcs[act], alpha, gain, clamp),
    fake=lambda x, b, act, alpha, gain, clamp: x.new_empty(x.shape))


class _BiasAct(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor),
    channel-last.  Backward: plain ops on the saved inputs, differentiable
    again."""

    @staticmethod
    def forward(ctx, x, b, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (act, alpha, gain, clamp)
        return op(x, b, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        act, alpha, gain, clamp = ctx.args
        spec = activation_funcs[act]
        t = x.to(_acc(x))
        if b is not None:
            t = t + b.to(x.dtype).to(t.dtype)
        d = spec.dfunc(t, alpha) * gain
        if clamp >= 0:
            y = spec.func(t, alpha) * gain
            d = d * ((y >= -clamp) & (y <= clamp)).to(d.dtype)
        dt = g.to(d.dtype) * d
        dx = dt.to(x.dtype) if ctx.needs_input_grad[0] else None
        db = None
        if b is not None and ctx.needs_input_grad[1]:
            db = dt.reshape(-1, dt.shape[-1]).sum(0).to(b.dtype)
        return dx, db, None, None, None, None


def bias_act_channel_last(x: torch.Tensor, b: Optional[torch.Tensor],
                          act: str, alpha: float, gain: float,
                          clamp: float) -> torch.Tensor:
    """``clamp(gain * act(x + b))`` with ``b`` along the last axis of ``x``
    and resolved arguments (``clamp`` < 0: none); differentiable to second
    order in ``x`` and ``b``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16; made contiguous first)."""
    if b is not None and b.shape != (x.shape[-1],):
        raise ValueError(f"{NAME}: bias shape {tuple(b.shape)} != "
                         f"({x.shape[-1]},)")
    return _BiasAct.apply(x.contiguous(), b, act, alpha, gain, clamp)
