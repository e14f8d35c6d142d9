"""The conditional Progressive GAN ("proper" family: a 4x4 head, a label
embedding concatenated to z in G, a spatial label plane per resolution in
D), forward passes in plain PyTorch over NCHW tensors.

Parameters are a flat dict of raw N(0, 1) weights and zero biases in the
published layouts (conv kernels HWIO, the latent projection HWOI), keyed as
the configuration's parameter list names them (``param_shapes``).  The
equalized learning rate's He constant is applied at every use, as the
published method does, with the reference's fan-in quirk for the
transposed 4x4 input layer (out_ch * 16).

G:  [z, embed(label)] -> 4x4 (transposed conv) -> pixel norm -> lrelu
    -> 3x3 conv block at 4x4 -> per stage: bilinear 2x, two 3x3 convs, each
    + bias -> pixel norm -> lrelu -> 1x1 to_rgb (no tanh).
D:  [image, label plane] -> 1x1 from_rgb -> per stage: two 3x3 convs with
    pixel norm and lrelu, 2x2 mean pool -> minibatch stddev channel -> 3x3
    conv, 4x4 valid conv -> linear.

``prec.q`` is applied to both operands of every convolution and matrix
product: the identity for the reference, float8 for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-8
SLOPE = 0.2


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


class Prec:
    """How the products' operands are held: ``q`` rounds an operand."""

    def __init__(self, q: Optional[Callable] = None):
        self.q = q or _ident


def g_param_shapes(g: dict) -> Dict[str, tuple]:
    """Name -> (shape, init) of the generator's parameters; init is
    'normal' (N(0, 1)) or 'zero'."""
    ch, z, e = g["channels"], g["z_dim"], g["embed_dim"]
    out = {"embedding.w": ((g["num_classes"], e), "normal"),
           "input.w": ((4, 4, ch[0], z + e), "normal"),
           "input.b": ((ch[0],), "zero"),
           "blocks.4.conv1.w": ((3, 3, ch[0], ch[0]), "normal"),
           "blocks.4.conv1.b": ((ch[0],), "zero")}
    for k in range(1, len(ch)):
        res = 4 * 2 ** k
        out[f"blocks.{res}.conv1.w"] = ((3, 3, ch[k - 1], ch[k]), "normal")
        out[f"blocks.{res}.conv1.b"] = ((ch[k],), "zero")
        out[f"blocks.{res}.conv2.w"] = ((3, 3, ch[k], ch[k]), "normal")
        out[f"blocks.{res}.conv2.b"] = ((ch[k],), "zero")
    for k in range(len(ch)):
        res = 4 * 2 ** k
        out[f"to_rgb.{res}.w"] = ((1, 1, ch[k], 3), "normal")
        out[f"to_rgb.{res}.b"] = ((3,), "zero")
    return out


def d_param_shapes(d: dict) -> Dict[str, tuple]:
    """Name -> (shape, init) of the discriminator's parameters."""
    si, so = d["stage_in"], d["stage_out"]
    out = {}
    for k in range(len(si)):
        res = 4 * 2 ** k
        if k == 0:
            out["blocks.4.conv1.w"] = ((3, 3, si[0] + 1, so[0]), "normal")
            out["blocks.4.conv2.w"] = ((4, 4, so[0], so[0]), "normal")
        else:
            out[f"blocks.{res}.conv1.w"] = ((3, 3, si[k], so[k]), "normal")
            out[f"blocks.{res}.conv2.w"] = ((3, 3, so[k], so[k]), "normal")
        out[f"blocks.{res}.conv1.b"] = ((so[k],), "zero")
        out[f"blocks.{res}.conv2.b"] = ((so[k],), "zero")
        out[f"from_rgb.{res}.w"] = ((1, 1, 4, si[k]), "normal")
        out[f"from_rgb.{res}.b"] = ((si[k],), "zero")
        out[f"embeddings.{res}.w"] = ((d["num_classes"], res * res),
                                      "normal")
    out["linear.w"] = ((so[0], 1), "normal")
    out["linear.b"] = ((1,), "zero")
    return out


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, b: Optional[torch.Tensor],
          padding: int, prec: Prec) -> torch.Tensor:
    kh, kw, cin, _ = w_hwio.shape
    w = (w_hwio * math.sqrt(2.0 / (cin * kh * kw))).permute(3, 2, 0, 1)
    y = F.conv2d(prec.q(x), prec.q(w), padding=padding)
    return y if b is None else y + b.view(1, -1, 1, 1)


def _pn_lrelu(x: torch.Tensor) -> torch.Tensor:
    x = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + EPS)
    return F.leaky_relu(x, SLOPE)


def _conv_pn(p: Params, name: str, x: torch.Tensor, padding: int,
             prec: Prec) -> torch.Tensor:
    return _pn_lrelu(_conv(x, p[name + ".w"], p[name + ".b"], padding, prec))


def generator(p: Params, g: dict, z: torch.Tensor, labels: torch.Tensor,
              step: int, prec: Prec = Prec()) -> torch.Tensor:
    """Images (B, H, W, 3) at ``step`` (stage ``step - 1``), alpha 1."""
    x = torch.cat([z, p["embedding.w"][labels.long()]], dim=1)
    w = p["input.w"]
    c0, n_in = w.shape[2], w.shape[3]
    wm = (w * math.sqrt(2.0 / (c0 * 16))).reshape(16 * c0, n_in)
    x = (prec.q(x) @ prec.q(wm).t()).reshape(-1, 4, 4, c0)
    x = _pn_lrelu((x + p["input.b"]).permute(0, 3, 1, 2))
    x = _conv_pn(p, "blocks.4.conv1", x, 1, prec)
    stage = min(step, g["max_step"]) - 1
    for k in range(1, stage + 1):
        res = 4 * 2 ** k
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = _conv_pn(p, f"blocks.{res}.conv1", x, 1, prec)
        x = _conv_pn(p, f"blocks.{res}.conv2", x, 1, prec)
    res = 4 * 2 ** stage
    rgb = _conv(x, p[f"to_rgb.{res}.w"], p[f"to_rgb.{res}.b"], 0, prec)
    return rgb.permute(0, 2, 3, 1)


def discriminator(p: Params, d: dict, img: torch.Tensor,
                  labels: torch.Tensor, step: int,
                  prec: Prec = Prec()) -> torch.Tensor:
    """Scores (B,) of NHWC images entering at ``step``, alpha 1."""
    x = img.permute(0, 3, 1, 2)
    b, res = x.shape[0], x.shape[-1]
    plane = p[f"embeddings.{res}.w"][labels.long()].reshape(b, 1, res, res)
    x = _conv(torch.cat([x, plane], dim=1), p[f"from_rgb.{res}.w"],
              p[f"from_rgb.{res}.b"], 0, prec)
    entry = min(step, d["max_step"]) - 1
    for k in range(entry, 0, -1):
        r = 4 * 2 ** k
        x = _conv_pn(p, f"blocks.{r}.conv1", x, 1, prec)
        x = _conv_pn(p, f"blocks.{r}.conv2", x, 1, prec)
        x = F.avg_pool2d(x, 2)
    std = torch.sqrt(torch.var(x, dim=0, unbiased=False) + EPS).mean()
    x = torch.cat([x, std.expand(b, 1, x.shape[2], x.shape[3])], dim=1)
    x = _conv_pn(p, "blocks.4.conv1", x, 1, prec)
    x = _conv_pn(p, "blocks.4.conv2", x, 0, prec)
    h = x.reshape(b, -1)
    w = p["linear.w"] * math.sqrt(2.0 / p["linear.w"].shape[0])
    return (prec.q(h) @ prec.q(w)).reshape(-1) + p["linear.b"]
