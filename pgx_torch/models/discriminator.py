"""Unified progressive discriminator (counterpart of
``pgx/models/discriminator.py``).

``Discriminator`` holds the parameters under ``pgx``'s key names and
layouts (``blocks.<res>.conv<i>.{w,b}``, ``from_rgb.<res>.{w,b}``,
``embeddings.<res>.w``, ``embedding.w``, ``linear.{w,b}``; res =
4 * 2**stage), so a ``pgx`` params tree loads by name with
``Discriminator.from_jax_params(cfg, tree)``.  PixelNorm is always on in
the blocks.

Every conv block is called with ``fused=False``: the discriminator sits
under the gradient penalty's double backward, so its convs are cuDNN's and
their epilogues kernel A; kernel C never runs here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from pgx_torch.core import layers as L
from pgx_torch.models.config import DiscriminatorConfig
from pgx_torch.models.generator import (Params, l2_normalize,
                                        load_params_tree)
from pgx_torch.ops.resize import downsample2x
from pgx_torch.utils import resolve_device


def init_discriminator(cfg: DiscriminatorConfig, seed: int = 0) -> Params:
    """A numpy params tree in ``pgx``'s layout and key names: N(0,1)
    weights and zero biases from ``numpy.random.RandomState(seed)`` (the
    numbers differ from ``pgx``'s JAX draws; layout and distribution are
    the same)."""
    rng = np.random.RandomState(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def conv(in_ch, out_ch, k):
        return {"w": normal(k, k, in_ch, out_ch),
                "b": np.zeros(out_ch, np.float32)}

    params: Params = {"blocks": {}, "from_rgb": {}}
    rgb_in = cfg.img_channels + (cfg.conditioning == "label_plane")
    for k in range(cfg.num_stages):
        res = str(4 * 2 ** k)
        cin, cout = cfg.stage_in[k], cfg.stage_out[k]
        if k == 0:
            blk = {"conv1": conv(cin + 1, cout, 3),
                   "conv2": conv(cout, cout, 4)}
        elif cfg.block_type == "single":
            blk = {"conv1": conv(cin, cout, 3)}
        else:
            blk = {"conv1": conv(cin, cout, 3), "conv2": conv(cout, cout, 3)}
        params["blocks"][res] = blk
        params["from_rgb"][res] = conv(rgb_in, cin, 1)
    if cfg.conditioning == "label_plane":
        params["embeddings"] = {
            str(4 * 2 ** k): {"w": normal(cfg.num_classes,
                                          (4 * 2 ** k) ** 2)}
            for k in range(cfg.num_stages)}
    elif cfg.conditioning == "projection":
        params["embedding"] = {"w": normal(cfg.num_classes, cfg.feat_dim)}
    params["linear"] = {"w": normal(cfg.feat_dim, 1),
                        "b": np.zeros(1, np.float32)}
    return params


class Discriminator(nn.Module):
    """The discriminator's parameters as modules, keyed like ``pgx``'s
    tree.  Parameters are trainable."""

    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        rgb_in = cfg.img_channels + (cfg.conditioning == "label_plane")
        blocks, from_rgb = {}, {}
        for k in range(cfg.num_stages):
            res = str(4 * 2 ** k)
            cin, cout = cfg.stage_in[k], cfg.stage_out[k]
            if k == 0:
                # final 4x4 block: (in + 1 stddev) -> 3x3 pad1 -> 4x4 valid
                blocks[res] = L.ConvBlock(cin + 1, cout, 3, 4)
            elif cfg.block_type == "single":
                blocks[res] = L.SingleConvBlock(cin, cout, 3)
            else:
                blocks[res] = L.ConvBlock(cin, cout)
            from_rgb[res] = L.EqualConv2d(rgb_in, cin, 1)
        self.blocks = nn.ModuleDict(blocks)
        self.from_rgb = nn.ModuleDict(from_rgb)
        if cfg.conditioning == "label_plane":
            self.embeddings = nn.ModuleDict({
                str(4 * 2 ** k): L.Embedding(cfg.num_classes,
                                             (4 * 2 ** k) ** 2)
                for k in range(cfg.num_stages)})
        elif cfg.conditioning == "projection":
            self.embedding = L.Embedding(cfg.num_classes, cfg.feat_dim)
        self.linear = L.EqualLinear(cfg.feat_dim, 1)

    @classmethod
    def from_jax_params(cls, cfg: DiscriminatorConfig, tree: Params,
                        device="cuda") -> "Discriminator":
        """Carry ``pgx`` discriminator params (a nested dict of numpy
        arrays in ``pgx``'s layout) over into the module, on ``device``,
        in the arrays' own dtype."""
        return load_params_tree(cls(cfg), tree).to(resolve_device(device))

    def forward(self, img: torch.Tensor,
                labels: Optional[torch.Tensor] = None, *, step: int,
                alpha=1.0, fading: bool = False,
                stddev_groups: int = 1, stddev_group=None) -> torch.Tensor:
        return discriminator_apply(self, img, labels, step=step, alpha=alpha,
                                   fading=fading, stddev_groups=stddev_groups,
                                   stddev_group=stddev_group)


def _block(disc: Discriminator, k: int, x: torch.Tensor) -> torch.Tensor:
    p = disc.blocks[str(4 * 2 ** k)]
    if k == 0:
        return L.conv_block(p, x, padding1=1, padding2=0, fused=False)
    if disc.cfg.block_type == "single":
        return L.single_conv_block(p, x, padding=1, fused=False)
    return L.conv_block(p, x, fused=False)


def _from_rgb(disc: Discriminator, k: int, img: torch.Tensor,
              labels: Optional[torch.Tensor]) -> torch.Tensor:
    cfg = disc.cfg
    if cfg.conditioning == "label_plane":
        # the per-resolution spatial label plane, one more image channel
        res = img.shape[1]
        plane = L.embedding(disc.embeddings[str(res)].w, labels,
                            equalized=cfg.equal_embed, dtype=img.dtype)
        img = torch.cat([img, plane.reshape(-1, res, res, 1)], dim=-1)
    conv = disc.from_rgb[str(4 * 2 ** k)]
    return L.equal_conv2d(conv.w, conv.b, img)


def discriminator_apply(disc: Discriminator, img: torch.Tensor,
                        labels: Optional[torch.Tensor] = None, *, step: int,
                        alpha=1.0, fading: bool = False,
                        stddev_groups: int = 1,
                        stddev_group=None) -> torch.Tensor:
    """Score a batch of NHWC images entering at the resolution of ``step``.

    Returns (B, 1) for the plain and label-plane heads, (B,) for the
    projection head.  ``stddev_groups > 1`` takes the minibatch-stddev
    statistic per contiguous B/groups slice (``TrainConfig.d_concat``);
    ``stddev_group`` (a process group, ``pgx``'s ``stddev_axis_name``)
    takes it over the batch of every rank."""
    cfg = disc.cfg
    step = min(step, cfg.max_step)
    dtype = cfg.compute_dtype
    img = img.to(dtype)
    entry = cfg.entry_stage(step)

    x = _from_rgb(disc, entry, img, labels)
    for k in range(entry, 0, -1):
        x = downsample2x(_block(disc, k, x))
        if k == entry and fading:
            a = torch.as_tensor(alpha, dtype=dtype, device=x.device)
            skip = _from_rgb(disc, entry - 1, downsample2x(img), labels)
            x = (1 - a) * skip + a * x

    x = L.minibatch_stddev(x, groups=stddev_groups, group=stddev_group)
    x = _block(disc, 0, x)                      # -> (B, 1, 1, feat)
    h = x.reshape(x.shape[0], -1)
    out = L.equal_linear(disc.linear.w, disc.linear.b, h)

    if cfg.conditioning == "projection":
        embed = l2_normalize(L.embedding(disc.embedding.w, labels,
                                         dtype=dtype))
        return out.reshape(-1) + torch.sum(h * embed, dim=-1)
    return out
