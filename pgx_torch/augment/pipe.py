"""ADA augmentation pipeline (counterpart of ``pgx/augment/pipe.py``).

The 15 transforms of the reference's AugmentPipe: pixel blitting, a single
inverse homography for all geometric warps, a 4x4 homogeneous color matrix,
a 4-band wavelet filter bank, noise, and cutout, driven by one scalar
probability ``p`` and a source of random draws.

The reflect-pad margin of the geometric stage is the static worst case
``(width - 1, height - 1)`` that the reference clamps its data-dependent
margin to.  ``debug_percentile`` reproduces the reference's deterministic
mode and is the parity hook.

Random draws.  pgx splits one key into 48 and consumes them in call order
through ``rand``/``randn``; other generators give other numbers, so this
pipe takes a *draw source*: an object with ``uniform(shape)`` and
``normal(shape)`` returning float32 tensors on the images' device, called
in exactly pgx's order and shapes (a transform's value first, then its
gate).  ``TorchDraws`` wraps a ``torch.Generator``; a parity test passes a
source that hands out pgx's own numbers.

The transform matrices are float32 whatever the image type, as in pgx;
mixed-type products promote as jnp does (a bf16 image leaves the color
stage as float32).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pgx_torch.ops.grid_sample import affine_grid, grid_sample
from pgx_torch.ops.upfirdn2d import downsample2d, upsample2d
from pgx_torch.ops.warp import ada_geom_warp_shear

# Wavelet low-pass coefficients used by the pipeline (only the two filters
# the pipe consumes).
WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702,
             -0.11799011114819057, -0.048311742585633, 0.4910559419267466,
             0.787641141030194, 0.3379294217276218, -0.07263752278646252,
             -0.021060292512300564, 0.04472490177066578,
             0.0017677118642428036, -0.007800708325034148],
}


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers and ranges (the reference's defaults)."""

    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # Geometric-warp backend: 'shear' = the gather-free multi-pass warp
    # (pgx_torch.ops.warp: kernels W and F; exact for every non-rotation
    # transform); 'gather' = the grid_sample formulation that matches the
    # reference (the oracle / non-square fallback; runs kernel D).
    warp_impl: str = "shear"
    # static shear-shift budget in units of half the output extent; 1.0
    # covers all pure rotations
    shear_margin: float = 1.0


def bgc_config(**overrides) -> AugmentConfig:
    """The ADA paper's default 'bgc' policy: blit + geom + color enabled."""
    base = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                saturation=1)
    base.update(overrides)
    return AugmentConfig(**base)


class TorchDraws:
    """The default draw source: float32 draws from an explicit
    ``torch.Generator``, on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device, dtype=torch.float32)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)


class RankRows:
    """One rank's rows of a draw source's global draws: each call draws the
    global batch's shape (``world`` times the rows asked for, on the
    leading axis) from ``source`` and keeps rows ``[rank * b, (rank + 1) *
    b)``.  Every rank holds a source in the same state, so together the
    ranks apply the draws a single process would at the global batch."""

    def __init__(self, source, rank: int, world: int):
        self.source, self.rank, self.world = source, rank, world

    def _rows(self, fn, shape) -> torch.Tensor:
        b = shape[0]
        full = fn((b * self.world,) + tuple(shape[1:]))
        return full[self.rank * b:(self.rank + 1) * b]

    def uniform(self, shape) -> torch.Tensor:
        return self._rows(self.source.uniform, shape)

    def normal(self, shape) -> torch.Tensor:
        return self._rows(self.source.normal, shape)


@functools.lru_cache(maxsize=1)
def _filter_bank() -> np.ndarray:
    """4-band bandpass bank from sym2.  Lazy: scipy is only needed when the
    imgfilter transform is actually used."""
    import scipy.signal
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    bank = np.eye(4, 1)
    for i in range(1, bank.shape[0]):
        bank = np.dstack([bank, np.zeros_like(bank)]).reshape(
            bank.shape[0], -1)[:, :-1]
        bank = scipy.signal.convolve(bank, [hz_lo2])
        lo = (bank.shape[1] - hz_hi2.size) // 2
        bank[i, lo:lo + hz_hi2.size] += hz_hi2
    return bank


@functools.lru_cache(maxsize=1)
def _hz_geom() -> np.ndarray:
    """Normalized sym6 low-pass (``setup_filter`` semantics), numpy f32."""
    f = np.asarray(WAVELETS["sym6"], np.float64)
    return (f / f.sum()).astype(np.float32)


# --- batched homogeneous-matrix helpers, float32 ----------------------------

def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device; a Python number is
    filled in on the device rather than copied from the host."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32,
                          device=like.device)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    """[B, n, n] float32 identities on ``like``'s device, B from ``like``."""
    return torch.eye(n, dtype=torch.float32, device=like.device).repeat(
        like.shape[0], 1, 1)


def _with(m: torch.Tensor, entries) -> torch.Tensor:
    for i, j, val in entries:
        m[:, i, j] = val
    return m


def _translate2d(tx, ty):
    tx, ty = tx.to(torch.float32), ty.to(torch.float32)
    return _with(_eye(3, tx), [(0, 2, tx), (1, 2, ty)])


def _scale2d(sx, sy):
    sx, sy = sx.to(torch.float32), sy.to(torch.float32)
    return _with(_eye(3, sx), [(0, 0, sx), (1, 1, sy)])


def _rotate2d(theta):
    theta = theta.to(torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    return _with(_eye(3, theta), [(0, 0, c), (0, 1, -s), (1, 0, s),
                                  (1, 1, c)])


def _translate3d(tx, ty, tz):
    tx, ty, tz = (t.to(torch.float32) for t in (tx, ty, tz))
    return _with(_eye(4, tx), [(0, 3, tx), (1, 3, ty), (2, 3, tz)])


def _scale3d(sx, sy, sz):
    sx, sy, sz = (t.to(torch.float32) for t in (sx, sy, sz))
    return _with(_eye(4, sx), [(0, 0, sx), (1, 1, sy), (2, 2, sz)])


def _rotate3d(v, theta):
    v, theta = v.to(torch.float32), theta.to(torch.float32)
    vx, vy, vz = v[0], v[1], v[2]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    return _with(_eye(4, theta), [
        (0, 0, vx * vx * cc + c), (0, 1, vx * vy * cc - vz * s),
        (0, 2, vx * vz * cc + vy * s),
        (1, 0, vy * vx * cc + vz * s), (1, 1, vy * vy * cc + c),
        (1, 2, vy * vz * cc - vx * s),
        (2, 0, vz * vx * cc - vy * s), (2, 1, vz * vy * cc + vx * s),
        (2, 2, vz * vz * cc + c),
    ])


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" pad of a size-``n`` axis by ``pad`` on
    each side: reflected again and again where ``pad`` reaches past the
    axis, as ``jnp.pad`` does (torch's reflect pad needs ``pad < n``)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def _full(b: int, value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((b,), value, dtype=torch.float32, device=like.device)


def augment_pipe(draws, images: torch.Tensor, cfg: AugmentConfig, p,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
    """Apply the ADA pipeline to an NHWC batch in [-1, 1].

    ``draws`` is the draw source (``TorchDraws`` or any object with
    ``uniform(shape)`` / ``normal(shape)``); ``p`` is the overall
    probability (a Python number or a 0-d tensor); transform groups whose
    multiplier in ``cfg`` is 0 are skipped and draw nothing, as in the
    reference.  Differentiable in ``images``; every draw-derived quantity
    is a constant of the graph."""
    b, height, width, c = images.shape
    dev = images.device
    p = _f32(p, images).detach()
    dp = (None if debug_percentile is None
          else _f32(debug_percentile, images))

    def rand(shape):
        return draws.uniform(shape).to(device=dev, dtype=torch.float32)

    def randn(shape):
        return draws.normal(shape).to(device=dev, dtype=torch.float32)

    def gate(value, prob, identity):
        """Bernoulli-select value vs identity per sample."""
        mask = rand(value.shape[:1] + (1,) * (value.ndim - 1)) < prob
        return torch.where(mask, value, identity)

    # ---------------- pixel blitting + geometric: G_inv -------------------
    g_inv = _eye(3, images)
    geom_active = any(getattr(cfg, n) > 0 for n in
                      ("xflip", "rotate90", "xint", "scale", "rotate",
                       "aniso", "xfrac"))
    ones_b = _full(b, 1.0, images)

    if cfg.xflip > 0:
        i = torch.floor(rand((b,)) * 2)
        i = gate(i, cfg.xflip * p, torch.zeros_like(i))
        if dp is not None:
            i = torch.ones_like(i) * torch.floor(dp * 2)
        g_inv = g_inv @ _scale2d(1 / (1 - 2 * i), ones_b)

    if cfg.rotate90 > 0:
        i = torch.floor(rand((b,)) * 4)
        i = gate(i, cfg.rotate90 * p, torch.zeros_like(i))
        if dp is not None:
            i = torch.ones_like(i) * torch.floor(dp * 4)
        g_inv = g_inv @ _rotate2d(math.pi / 2 * i)

    if cfg.xint > 0:
        t = (rand((b, 2)) * 2 - 1) * cfg.xint_max
        t = gate(t, cfg.xint * p, torch.zeros_like(t))
        if dp is not None:
            t = torch.ones_like(t) * ((dp * 2 - 1) * cfg.xint_max)
        g_inv = g_inv @ _translate2d(-torch.round(t[:, 0] * width),
                                     -torch.round(t[:, 1] * height))

    if cfg.scale > 0:
        s = torch.exp2(randn((b,)) * cfg.scale_std)
        s = gate(s, cfg.scale * p, torch.ones_like(s))
        if dp is not None:
            s = torch.ones_like(s) * torch.exp2(
                torch.erfinv(dp * 2 - 1) * cfg.scale_std)
        g_inv = g_inv @ _scale2d(1 / s, 1 / s)

    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * p, 0, 1))
    if cfg.rotate > 0:
        theta = (rand((b,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = gate(theta, p_rot, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.ones_like(theta) * (
                (dp * 2 - 1) * math.pi * cfg.rotate_max)
        g_inv = g_inv @ _rotate2d(theta)

    if cfg.aniso > 0:
        s = torch.exp2(randn((b,)) * cfg.aniso_std)
        s = gate(s, cfg.aniso * p, torch.ones_like(s))
        if dp is not None:
            s = torch.ones_like(s) * torch.exp2(
                torch.erfinv(dp * 2 - 1) * cfg.aniso_std)
        g_inv = g_inv @ _scale2d(1 / s, s)

    if cfg.rotate > 0:
        theta = (rand((b,)) * 2 - 1) * math.pi * cfg.rotate_max
        theta = gate(theta, p_rot, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.zeros_like(theta)
        g_inv = g_inv @ _rotate2d(theta)

    if cfg.xfrac > 0:
        t = randn((b, 2)) * cfg.xfrac_std
        t = gate(t, cfg.xfrac * p, torch.zeros_like(t))
        if dp is not None:
            t = torch.ones_like(t) * (
                torch.erfinv(dp * 2 - 1) * cfg.xfrac_std)
        g_inv = g_inv @ _translate2d(-t[:, 0] * width, -t[:, 1] * height)

    # ---------------- execute geometric transform --------------------------
    if geom_active:
        hz_np = _hz_geom()
        hz_pad = hz_np.shape[0] // 4

        if cfg.warp_impl == "shear" and height == width:
            # pads by the same static margin itself (pass 0)
            images = ada_geom_warp_shear(
                images, g_inv[:, :2, :2], g_inv[:, :2, 2], hz_np,
                shear_margin=cfg.shear_margin)
        else:
            # static worst-case reflect margin; F.pad reflects NCHW and
            # wants a margin below the size, which width - 1 is
            mx, my = width - 1, height - 1
            images = F.pad(images.permute(0, 3, 1, 2), (mx, mx, my, my),
                           mode="reflect").permute(0, 2, 3, 1)
            # symmetric pad => the (mx0-mx1)/2 origin shift is zero
            images = upsample2d(images, hz_np, up=2)
            s2 = _scale2d(_full(b, 2.0, images), _full(b, 2.0, images))
            s2_inv = _scale2d(_full(b, 0.5, images), _full(b, 0.5, images))
            t_half = _translate2d(_full(b, -0.5, images),
                                  _full(b, -0.5, images))
            t_half_inv = _translate2d(_full(b, 0.5, images),
                                      _full(b, 0.5, images))
            g_inv = s2 @ g_inv @ s2_inv
            g_inv = t_half @ g_inv @ t_half_inv

            out_h = (height + hz_pad * 2) * 2
            out_w = (width + hz_pad * 2) * 2
            in_h, in_w = images.shape[1], images.shape[2]
            sa = _scale2d(_full(b, 2 / in_w, images),
                          _full(b, 2 / in_h, images))
            sb = _scale2d(_full(b, out_w / 2, images),
                          _full(b, out_h / 2, images))
            g_inv = sa @ g_inv @ sb

            grid = affine_grid(g_inv[:, :2, :], (b, out_h, out_w))
            images = grid_sample(images, grid)
            images = downsample2d(images, hz_np, down=2,
                                  padding=-hz_pad * 2, flip_filter=True)

    # ---------------- color transform C ------------------------------------
    eye4 = _eye(4, images)
    cmat = eye4
    # the luma axis (1, 1, 1, 0) / sqrt(3), filled on the device: a copy
    # from pageable host memory (of an array, or of the scalar that item
    # assignment wraps) makes the host wait for the stream
    v = torch.full((4,), float(1 / np.sqrt(3)), dtype=torch.float32,
                   device=dev)
    v.narrow(0, 3, 1).zero_()

    if cfg.brightness > 0:
        bb = randn((b,)) * cfg.brightness_std
        bb = gate(bb, cfg.brightness * p, torch.zeros_like(bb))
        if dp is not None:
            bb = torch.ones_like(bb) * (
                torch.erfinv(dp * 2 - 1) * cfg.brightness_std)
        cmat = _translate3d(bb, bb, bb) @ cmat

    if cfg.contrast > 0:
        cc = torch.exp2(randn((b,)) * cfg.contrast_std)
        cc = gate(cc, cfg.contrast * p, torch.ones_like(cc))
        if dp is not None:
            cc = torch.ones_like(cc) * torch.exp2(
                torch.erfinv(dp * 2 - 1) * cfg.contrast_std)
        cmat = _scale3d(cc, cc, cc) @ cmat

    if cfg.lumaflip > 0:
        i = torch.floor(rand((b, 1, 1)) * 2)
        i = gate(i, cfg.lumaflip * p, torch.zeros_like(i))
        if dp is not None:
            i = torch.ones_like(i) * torch.floor(dp * 2)
        vv = torch.outer(v, v)
        cmat = (eye4 - 2 * vv[None] * i) @ cmat  # Householder reflection

    if cfg.hue > 0 and c > 1:
        theta = (rand((b,)) * 2 - 1) * math.pi * cfg.hue_max
        theta = gate(theta, cfg.hue * p, torch.zeros_like(theta))
        if dp is not None:
            theta = torch.ones_like(theta) * (
                (dp * 2 - 1) * math.pi * cfg.hue_max)
        cmat = _rotate3d(v[:3] / torch.linalg.norm(v[:3]), theta) @ cmat

    if cfg.saturation > 0 and c > 1:
        s = torch.exp2(randn((b, 1, 1)) * cfg.saturation_std)
        s = gate(s, cfg.saturation * p, torch.ones_like(s))
        if dp is not None:
            s = torch.ones_like(s) * torch.exp2(
                torch.erfinv(dp * 2 - 1) * cfg.saturation_std)
        vv = torch.outer(v, v)
        cmat = (vv[None] + (eye4 - vv[None]) * s) @ cmat

    color_active = any(getattr(cfg, n) > 0 for n in
                       ("brightness", "contrast", "lumaflip", "hue",
                        "saturation"))
    if color_active:
        # float32 matrices times the image promote as in jnp
        dt = torch.promote_types(images.dtype, torch.float32)
        flat = images.reshape(b, height * width, c).to(dt)    # (B, P, C)
        cmat_t = cmat.to(dt)
        if c == 3:
            flat = (torch.einsum("bij,bpj->bpi", cmat_t[:, :3, :3], flat)
                    + cmat_t[:, None, :3, 3])
        elif c == 1:
            cm = torch.mean(cmat_t[:, :3, :], dim=1, keepdim=True)  # (B,1,4)
            flat = (flat * torch.sum(cm[:, :, :3], dim=2)[:, None]
                    + cm[:, :, 3][:, None])
        else:
            raise ValueError("images must be RGB or grayscale")
        images = flat.reshape(b, height, width, c)

    # ---------------- image-space filtering --------------------------------
    if cfg.imgfilter > 0:
        fbank_np = _filter_bank().astype(np.float32)
        fbank = _f32(fbank_np, images)
        num_bands = fbank.shape[0]
        assert len(cfg.imgfilter_bands) == num_bands
        expected_power = _f32(np.array([10, 1, 1, 1]) / 13, images)
        g = torch.ones(b, num_bands, dtype=torch.float32, device=dev)
        for i, band_strength in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(randn((b,)) * cfg.imgfilter_std)
            t_i = gate(t_i, cfg.imgfilter * p * band_strength,
                       torch.ones_like(t_i))
            if dp is not None:
                t_i = (torch.ones_like(t_i) * torch.exp2(
                    torch.erfinv(dp * 2 - 1) * cfg.imgfilter_std)
                    if band_strength > 0 else torch.ones_like(t_i))
            t = torch.ones(b, num_bands, dtype=torch.float32, device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt(torch.sum(expected_power * torch.square(t),
                                         dim=-1, keepdim=True))
            g = g * t

        hz_prime = g @ fbank                           # (B, taps)
        taps = hz_prime.shape[1]
        pad = fbank_np.shape[1] // 2
        # two grouped convs over channels = B*C, one separable filter per
        # sample, outside any kernel as in pgx
        dt = torch.promote_types(images.dtype, torch.float32)
        x = images.to(dt).permute(0, 3, 1, 2).reshape(1, b * c, height,
                                                      width)
        x = x.index_select(2, _reflect_index(height, pad, dev))
        x = x.index_select(3, _reflect_index(width, pad, dev))
        k = torch.repeat_interleave(hz_prime, c, dim=0).to(dt)  # (B*C, taps)
        x = F.conv2d(x, k.reshape(b * c, 1, taps, 1), groups=b * c)
        x = F.conv2d(x, k.reshape(b * c, 1, 1, taps), groups=b * c)
        images = x.reshape(b, c, height, width).permute(0, 2, 3, 1)

    # ---------------- corruptions -------------------------------------------
    if cfg.noise > 0:
        sigma = torch.abs(randn((b, 1, 1, 1))) * cfg.noise_std
        sigma = gate(sigma, cfg.noise * p, torch.zeros_like(sigma))
        if dp is not None:
            sigma = torch.ones_like(sigma) * (
                torch.erfinv(dp) * cfg.noise_std)
        images = images + randn((b, height, width, c)) * sigma

    if cfg.cutout > 0:
        size = torch.full((b, 2, 1, 1, 1), cfg.cutout_size,
                          dtype=torch.float32, device=dev)
        size = gate(size, cfg.cutout * p, torch.zeros_like(size))
        center = rand((b, 2, 1, 1, 1))
        if dp is not None:
            size = torch.full_like(size, cfg.cutout_size)
            center = torch.ones_like(center) * dp
        coord_x = torch.arange(width, device=dev).reshape(1, 1, -1)
        coord_y = torch.arange(height, device=dev).reshape(1, -1, 1)
        mask_x = (torch.abs((coord_x + 0.5) / width - center[:, 0, :, :, 0])
                  >= size[:, 0, :, :, 0] / 2)
        mask_y = (torch.abs((coord_y + 0.5) / height - center[:, 1, :, :, 0])
                  >= size[:, 1, :, :, 0] / 2)
        mask = torch.logical_or(mask_x, mask_y).to(images.dtype)
        images = images * mask[..., None]

    return images.contiguous()
