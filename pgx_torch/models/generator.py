"""Unified progressive generator (counterpart of ``pgx/models/generator.py``).

``Generator`` holds the parameters under ``pgx``'s key names and layouts, so
a ``pgx`` params tree (numpy arrays, as ``load_params`` or
``jax.device_get(init_generator(...))`` returns them) loads by name:
``Generator.from_jax_params(cfg, tree)``.  Parameters are frozen unless the
caller asks for a trainable module (the serving path keeps them frozen; the
train state asks).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from pgx_torch.core import layers as L
from pgx_torch.models.config import GeneratorConfig
from pgx_torch.ops.kernels import pixel_norm_lrelu
from pgx_torch.ops.kernels.pixel_norm_lrelu import (
    supported as pixel_norm_lrelu_supported)
from pgx_torch.ops.resize import upsample2x
from pgx_torch.parallel.collectives import split_rows
from pgx_torch.utils import resolve_device

Params = Dict[str, Any]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(dim=-1): x / max(||x||_2, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def init_generator(cfg: GeneratorConfig, seed: int = 0) -> Params:
    """A numpy params tree in ``pgx``'s layout and key names: N(0,1)
    kernels (HWIO convs, the HWOI input layer, the embedding table) and
    zero biases, drawn from ``numpy.random.RandomState(seed)``.  The
    numbers differ from ``pgx``'s JAX draws; layout and distribution are
    the same."""
    rng = np.random.RandomState(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def conv(in_ch, out_ch, k):
        return {"w": normal(k, k, in_ch, out_ch),
                "b": np.zeros(out_ch, np.float32)}

    params: Params = {}
    in_dim = cfg.z_dim + cfg.embedding_dim
    if cfg.conditioning != "none":
        params["embedding"] = {"w": normal(cfg.num_classes,
                                           cfg.embedding_dim)}
    params["input"] = {"w": normal(4, 4, cfg.channels[0], in_dim),
                       "b": np.zeros(cfg.channels[0], np.float32)}
    c0 = cfg.channels[0]
    if cfg.arch == "proper" or cfg.block_type == "single":
        params["blocks"] = {"4": {"conv1": conv(c0, c0, 3)}}
    else:
        params["blocks"] = {"4": {"conv1": conv(c0, c0, 3),
                                  "conv2": conv(c0, c0, 3)}}
    for k in range(1, cfg.num_stages):
        cin, cout = cfg.channels[k - 1], cfg.channels[k]
        blk = {"conv1": conv(cin, cout, 3)}
        if cfg.block_type != "single":
            blk["conv2"] = conv(cout, cout, 3)
        params["blocks"][str(4 * 2 ** k)] = blk
    first_rgb = 0 if cfg.arch == "proper" else 1
    params["to_rgb"] = {str(4 * 2 ** k): conv(cfg.channels[k],
                                              cfg.img_channels, 1)
                        for k in range(first_rgb, cfg.num_stages)}
    return params


def _state_dict_of(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A pgx params tree as this module's state dict (keys joined by '.')."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state_dict_of(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v))
    return out


def load_params_tree(module: nn.Module, tree: Params) -> nn.Module:
    """Load a pgx params tree into ``module`` by name, strictly.  The
    parameters take the arrays' own dtype (an f64 tree stays f64) and keep
    the module's ``requires_grad``."""
    module.load_state_dict(_state_dict_of(tree), strict=True, assign=True)
    return module


class Generator(nn.Module):
    """The generator's parameters as modules, keyed like ``pgx``'s tree:
    ``embedding.w``, ``input.{w,b}``, ``blocks.<res>.conv<i>.{w,b}``,
    ``to_rgb.<res>.{w,b}`` (res = 4 * 2**stage)."""

    def __init__(self, cfg: GeneratorConfig, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        if cfg.conditioning != "none":
            self.embedding = L.Embedding(cfg.num_classes, cfg.embedding_dim)
        self.input = L.EqualConvTranspose2d(cfg.z_dim + cfg.embedding_dim,
                                            cfg.channels[0], 4)
        c0 = cfg.channels[0]
        blocks = {}
        if cfg.arch == "proper" or cfg.block_type == "single":
            blocks["4"] = L.SingleConvBlock(c0, c0, 3)
        else:
            blocks["4"] = L.ConvBlock(c0, c0)
        for k in range(1, cfg.num_stages):
            cin, cout = cfg.channels[k - 1], cfg.channels[k]
            blocks[str(4 * 2 ** k)] = (
                L.SingleConvBlock(cin, cout, 3)
                if cfg.block_type == "single" else L.ConvBlock(cin, cout))
        self.blocks = nn.ModuleDict(blocks)
        first_rgb = 0 if cfg.arch == "proper" else 1
        self.to_rgb = nn.ModuleDict({
            str(4 * 2 ** k): L.EqualConv2d(cfg.channels[k], cfg.img_channels,
                                           1)
            for k in range(first_rgb, cfg.num_stages)})
        self.requires_grad_(trainable)

    @classmethod
    def from_jax_params(cls, cfg: GeneratorConfig, tree: Params,
                        device="cuda", trainable: bool = False
                        ) -> "Generator":
        """Carry ``pgx`` generator params (a nested dict of numpy arrays in
        ``pgx``'s layout) over into the module, on ``device``, in the
        arrays' own dtype."""
        dev = resolve_device(device)
        return load_params_tree(cls(cfg, trainable), tree).to(dev)

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
                *, step: int, alpha=1.0, fading: bool = False,
                rows=None) -> torch.Tensor:
        return generator_apply(self, z, labels, step=step, alpha=alpha,
                               fading=fading, rows=rows)


def _block(gen: Generator, k: int, x: torch.Tensor,
           upsample_first: bool = False, rows=None) -> torch.Tensor:
    cfg = gen.cfg
    p = gen.blocks[str(4 * 2 ** k)]
    if k == 0 and cfg.arch == "proper":
        # PixelNorm hardcoded in the reference's fused 4x4 block
        return L.single_conv_block(p, x, padding=1, use_pixel_norm=True,
                                   rows=rows)
    if cfg.block_type == "single":
        return L.single_conv_block(p, x, padding=1,
                                   use_pixel_norm=cfg.pixel_norm,
                                   upsample_first=upsample_first, rows=rows)
    return L.conv_block(p, x, use_pixel_norm=cfg.pixel_norm,
                        upsample_first=upsample_first, rows=rows)


def _to_rgb(gen: Generator, k: int, x: torch.Tensor) -> torch.Tensor:
    conv = gen.to_rgb[str(4 * 2 ** k)]
    return L.equal_conv2d(conv.w, conv.b, x)


def generator_apply(gen: Generator, z: torch.Tensor,
                    labels: Optional[torch.Tensor] = None, *, step: int,
                    alpha=1.0, fading: bool = False,
                    rows=None) -> torch.Tensor:
    """A batch of NHWC images at the resolution of ``step``.

    ``fading`` selects the alpha blend with the previous stage's head (the
    reference's ``0 <= alpha < 1`` branch).

    ``rows`` (a ``tp.Mesh2D`` in spatial mode, whose ``n_model`` divides
    the resolution): the images come out as this rank's rows, split over H
    across the model group.  G splits at the first resolution ``n_model``
    divides: its 4x4 input (the latent projection computed whole and cut,
    kernel B on the rank's rows) for ``n_model <= 4``, else after the first
    stage that high; every conv above runs on rows with halos
    (``pgx_torch.core.layers``), as do the upsamples and the fading blend's
    upsample of the previous head."""
    cfg = gen.cfg
    step = min(step, cfg.max_step)
    dtype = cfg.compute_dtype
    z = z.to(dtype)
    split = rows is not None and rows.n_model > 1
    lay = None        # the layout so far: None whole, else ``rows``

    def place(x):
        # whole until the height splits over the model axis
        nonlocal lay
        if split and lay is None and x.shape[1] % rows.n_model == 0:
            lay = rows
            return split_rows(x, rows)
        return x

    if cfg.conditioning != "none":
        embed = L.embedding(gen.embedding.w, labels,
                            equalized=cfg.equal_embed, dtype=dtype)
        if cfg.conditioning == "norm_concat":
            z = torch.cat([l2_normalize(z), l2_normalize(embed)], dim=-1)
        else:
            z = torch.cat([z, embed], dim=-1)

    # stage 0: latent -> 4x4, then pixel-norm + lrelu (kernel B where it
    # takes the width)
    x = place(L.latent_to_4x4(gen.input.w, gen.input.b, z).contiguous())
    if pixel_norm_lrelu_supported(x):
        x = pixel_norm_lrelu(x, cfg.input_lrelu_slope)
    else:
        x = L.leaky_relu(L.pixel_norm(x), cfg.input_lrelu_slope)
    x = place(_block(gen, 0, x, rows=lay))

    out_stage = cfg.out_stage(step)
    feats = {0: (x, lay)}
    for k in range(1, out_stage + 1):
        height = x.shape[1] * (lay.n_model if lay is not None else 1)
        if (cfg.fuse_up_conv_min_size
                and height >= cfg.fuse_up_conv_min_size):
            x = _block(gen, k, x, upsample_first=True, rows=lay)
        else:
            x = _block(gen, k, upsample2x(x, lay), rows=lay)
        x = place(x)
        feats[k] = (x, lay)
    if split and lay is None:
        raise ValueError(f"a {x.shape[1]}px image does not split over "
                         f"{rows.n_model} model ranks "
                         f"(tp.use_spatial_sharding)")

    # the proper arch's step==2-with-tanh quirk skips the blend
    no_fade_quirk = cfg.arch == "proper" and step == 2 and cfg.tanh
    first_head = 0 if cfg.arch == "proper" else 1
    can_fade = out_stage > first_head and not no_fade_quirk
    if fading and can_fade:
        a = torch.as_tensor(alpha, dtype=dtype, device=x.device)
        prev, prev_lay = feats[out_stage - 1]
        skip = upsample2x(_to_rgb(gen, out_stage - 1, prev), prev_lay)
        if prev_lay is None and lay is not None:
            skip = split_rows(skip, lay)
        rgb = (1 - a) * skip + a * _to_rgb(gen, out_stage, x)
    else:
        rgb = _to_rgb(gen, out_stage, x)
    if cfg.tanh:
        rgb = torch.tanh(rgb)
    return rgb
