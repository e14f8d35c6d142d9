"""pytorch_fid's FID InceptionV3 (counterpart of ``pgx/eval/inception.py``).

The torchvision Inception-v3 with pytorch_fid's FID changes: the A/C/E
blocks' 3x3 average pools use ``count_include_pad=False``, Mixed_7c pools
its branch with a 3x3 stride-1 max pool, and the features are the global
mean of the last block (pool3, 2048 wide).  The module tree's
``state_dict()`` keys are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ...), so an official weights file
(pytorch_fid's ``pt_inception-2015-12-05`` or torchvision's
``inception_v3``) loads by name through ``load_torch_weights``.  Without
one, ``init_inception`` gives random weights: the pipeline runs, the FID
scale is not the published one.

BatchNorm is inference-mode and folded as ``pgx`` folds it:
``scale = gamma * rsqrt(var + 1e-3)``, ``shift = beta - mean * scale``,
``relu(x * scale + shift)``; the fold is made once, when the weights are
loaded.  Inside, tensors are NCHW in the
``channels_last`` memory format (cuDNN's NHWC kernels); the extractor
(``pgx_torch.eval.fid.make_extractor``) takes and returns ``pgx``'s layouts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

StateDict = Dict[str, torch.Tensor]

POOL3_DIM = 2048
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


# ---------------------------------------------------------------------------
# Architecture spec: (name, in_ch, out_ch, (kh, kw), stride, (ph, pw))
# ---------------------------------------------------------------------------

def _stem_spec() -> List[Tuple]:
    return [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ]


def _block_specs() -> Dict[str, List[Tuple]]:
    """Per mixed block: its convs as (branch_name, in, out, k, s, p)."""
    def a(in_ch, pool):
        return [
            ("branch1x1", in_ch, 64, (1, 1), 1, (0, 0)),
            ("branch5x5_1", in_ch, 48, (1, 1), 1, (0, 0)),
            ("branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            ("branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            ("branch_pool", in_ch, pool, (1, 1), 1, (0, 0)),
        ]

    def b(in_ch):
        return [
            ("branch3x3", in_ch, 384, (3, 3), 2, (0, 0)),
            ("branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
        ]

    def c(in_ch, c7):
        return [
            ("branch1x1", in_ch, 192, (1, 1), 1, (0, 0)),
            ("branch7x7_1", in_ch, c7, (1, 1), 1, (0, 0)),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", in_ch, c7, (1, 1), 1, (0, 0)),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
        ]

    def d(in_ch):
        return [
            ("branch3x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
            ("branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
            ("branch7x7x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
        ]

    def e(in_ch):
        return [
            ("branch1x1", in_ch, 320, (1, 1), 1, (0, 0)),
            ("branch3x3_1", in_ch, 384, (1, 1), 1, (0, 0)),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", in_ch, 448, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
        ]

    return {
        "Mixed_5b": a(192, 32), "Mixed_5c": a(256, 64), "Mixed_5d": a(288, 64),
        "Mixed_6a": b(288),
        "Mixed_6b": c(768, 128), "Mixed_6c": c(768, 160),
        "Mixed_6d": c(768, 160), "Mixed_6e": c(768, 192),
        "Mixed_7a": d(768),
        "Mixed_7b": e(1280), "Mixed_7c": e(2048),
    }


def conv_specs() -> List[Tuple]:
    """Every conv of the network in order, as (full_name, in, out, (kh,
    kw), stride, (ph, pw)); full names are torchvision's module paths."""
    specs = list(_stem_spec())
    for block, convs in _block_specs().items():
        specs += [(f"{block}.{branch}", *rest) for (branch, *rest) in convs]
    return specs


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _FoldedBatchNorm(nn.Module):
    """Inference BatchNorm(eps=1e-3) with torchvision's buffer names, folded
    into one scale and shift as ``pgx`` folds it.  The fold is made when
    the weights are loaded (``scale`` and ``shift`` are buffers that the
    state dict does not carry), with the same operations in the same
    order as a fold at every call would make."""

    def __init__(self, ch: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(ch))
        self.register_buffer("bias", torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.register_buffer("scale", torch.ones(ch), persistent=False)
        self.register_buffer("shift", torch.zeros(ch), persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, _incompatible: module.fold())

    @torch.no_grad()
    def fold(self) -> None:
        """``scale = gamma * rsqrt(var + 1e-3)``, ``shift = beta - mean *
        scale``, in the buffers' dtype and on their device."""
        self.scale = self.weight * torch.rsqrt(self.running_var + 1e-3)
        self.shift = self.bias - self.running_mean * self.scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x * self.scale.to(x.dtype)[:, None, None]
                          + self.shift.to(x.dtype)[:, None, None])


class BasicConv2d(nn.Module):
    """Conv (no bias) + folded BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride, padding):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                              bias=False)
        self.bn = _FoldedBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


def _max_pool3x3s2(x):
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_nip(x):
    """3x3 stride-1 average pool, count_include_pad=False (pytorch_fid's
    change to the A/C/E blocks)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Mixed(nn.Module):
    """One mixed block: its convs under their branch names, the forward
    by block kind (A, B, C, D, E, or E with the final max pool)."""

    def __init__(self, kind: str, convs: List[Tuple]):
        super().__init__()
        self.kind = kind
        for (name, i, o, k, s, p) in convs:
            self.add_module(name, BasicConv2d(i, o, k, s, p))

    def _chain(self, x, *names):
        for n in names:
            x = getattr(self, n)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "a":
            out = [self.branch1x1(x),
                   self._chain(x, "branch5x5_1", "branch5x5_2"),
                   self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                               "branch3x3dbl_3"),
                   self.branch_pool(_avg_pool_nip(x))]
        elif k == "b":
            out = [self.branch3x3(x),
                   self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                               "branch3x3dbl_3"),
                   _max_pool3x3s2(x)]
        elif k == "c":
            out = [self.branch1x1(x),
                   self._chain(x, "branch7x7_1", "branch7x7_2",
                               "branch7x7_3"),
                   self._chain(x, *(f"branch7x7dbl_{i}"
                                    for i in range(1, 6))),
                   self.branch_pool(_avg_pool_nip(x))]
        elif k == "d":
            out = [self._chain(x, "branch3x3_1", "branch3x3_2"),
                   self._chain(x, *(f"branch7x7x3_{i}" for i in range(1, 5))),
                   _max_pool3x3s2(x)]
        else:
            b3 = self.branch3x3_1(x)
            bd = self._chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
            pool = (F.max_pool2d(x, 3, stride=1, padding=1) if k == "e_max"
                    else _avg_pool_nip(x))
            out = [self.branch1x1(x),
                   self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                   self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
                   self.branch_pool(pool)]
        return torch.cat(out, dim=1)


_KINDS = {"Mixed_5b": "a", "Mixed_5c": "a", "Mixed_5d": "a", "Mixed_6a": "b",
          "Mixed_6b": "c", "Mixed_6c": "c", "Mixed_6d": "c", "Mixed_6e": "c",
          "Mixed_7a": "d", "Mixed_7b": "e", "Mixed_7c": "e_max"}


class InceptionV3(nn.Module):
    """Pool3 features of NCHW images at 299x299: ``(N, 3, 299, 299) ->
    (N, 2048)``."""

    def __init__(self):
        super().__init__()
        for (name, i, o, k, s, p) in _stem_spec():
            self.add_module(name, BasicConv2d(i, o, k, s, p))
        for block, convs in _block_specs().items():
            self.add_module(block, _Mixed(_KINDS[block], convs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _max_pool3x3s2(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool3x3s2(x)
        for block in _KINDS:
            x = getattr(self, block)(x)
        return torch.mean(x, dim=(2, 3))


# ---------------------------------------------------------------------------
# Weights: state dicts in torchvision's key names
# ---------------------------------------------------------------------------

def _keys(name: str) -> List[str]:
    return [f"{name}.conv.weight"] + [f"{name}.bn.{leaf}"
                                      for leaf in _BN_LEAVES]


def init_inception(generator: Optional[torch.Generator] = None
                   ) -> StateDict:
    """Random weights with every key of the network: ``pgx``'s init (conv
    weights normal * sqrt(1 / fan_in), identity BatchNorm), drawn from
    ``generator`` (seed 0 when None).  The draws differ from ``pgx``'s JAX
    ones; tests carry weights across instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    sd: StateDict = {}
    for (name, i, o, (kh, kw), _, _) in conv_specs():
        sd[f"{name}.conv.weight"] = (
            torch.randn((o, i, kh, kw), generator=generator)
            * float(np.sqrt(1.0 / (i * kh * kw))))
        sd[f"{name}.bn.weight"] = torch.ones(o)
        sd[f"{name}.bn.bias"] = torch.zeros(o)
        sd[f"{name}.bn.running_mean"] = torch.zeros(o)
        sd[f"{name}.bn.running_var"] = torch.ones(o)
    return sd


def load_torch_weights(path: str) -> StateDict:
    """The network's weights from a torch state dict file: pytorch_fid's
    ``pt_inception-2015-12-05`` checkpoint or torchvision's
    ``inception_v3``.  Keys the FID network does not have (``AuxLogits.*``,
    ``fc.*``, ``*.num_batches_tracked``) are ignored."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out: StateDict = {}
    for (name, *_rest) in conv_specs():
        for key in _keys(name):
            out[key] = sd[key]
    return out


def inception_from_jax_params(params: Dict[str, Any]) -> StateDict:
    """``pgx``'s Inception params (``{name: {w, gamma, beta, mean, var}}``,
    HWIO weights, as numpy) as a state dict of this network, each array in
    its own dtype."""
    sd: StateDict = {}
    for (name, *_rest) in conv_specs():
        p = params[name]
        sd[f"{name}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["w"]).transpose(3, 2, 0, 1)))
        for leaf, key in zip(_BN_LEAVES, ("gamma", "beta", "mean", "var")):
            sd[f"{name}.bn.{leaf}"] = torch.from_numpy(np.array(p[key]))
    return sd


def build_inception(params: Optional[StateDict] = None, *, device="cpu",
                    dtype=torch.float32) -> InceptionV3:
    """An ``InceptionV3`` in eval mode on ``device`` in ``dtype`` (the
    ``channels_last`` memory format), loaded from ``params`` (a state dict
    in torchvision's names; ``init_inception()`` when None), gradients
    off."""
    model = InceptionV3().to(dtype)
    model.load_state_dict(init_inception() if params is None else params,
                          strict=True)
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval().requires_grad_(False)


def inception_pool3(params: StateDict, x: torch.Tensor) -> torch.Tensor:
    """Pool3 features ``(N, 2048)`` of NHWC images ``x`` at 299x299, on
    ``x``'s device and in its dtype, with the weights of the state dict
    ``params``.  The input convention is pytorch_fid's after
    preprocessing (``pgx_torch.eval.fid.preprocess``)."""
    model = build_inception(params, device=x.device, dtype=x.dtype)
    with torch.inference_mode():
        return model(x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
