"""The ADA augmentation pipe's 'bgc' policy (Karras et al. 2020, "Training
Generative Adversarial Networks with Limited Data": blit, geometric and
color transforms) in plain PyTorch, with the geometric stage executed as
the gather-free shear warp the configuration names (``warp_impl:
shear``).

Random draws come from a draw source with ``uniform(shape)`` and
``normal(shape)``; each transform draws its value first and then its gate,
in the published order: xflip, rotate90, xint, scale, rotate, aniso, rotate,
xfrac, then brightness, contrast, lumaflip, hue, saturation.

The geometric operator is the published one: reflect pad, 2x upsample with
the sym6 low-pass, bilinear resampling at the inverse homography, 2x
downsample with the same filter.  The shear warp computes it as: an
optional transpose (the 90-degree part), the diagonal part as two resampling
matrices that fold the sym6 up-filter and the bilinear tent together,
landing on a 2x grid with static margins, a per-row and a per-column
fractional shift (linear interpolation, zero fill) for the two shears, and
the sym6 down-filter as two matrices.  Transforms without rotation give
exactly the published operator; rotations add the two 1-D interpolations
of the shears.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SYM6 = [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148]
TINY = 1e-8


# --- 3x3 and 4x4 homogeneous matrices, batched, float32 --------------------

def _mat(rows, b, dev):
    """A [B, n, n] matrix from nested lists of [B] tensors or numbers."""
    def col(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full((b,), float(v), dtype=torch.float32, device=dev)
    return torch.stack([torch.stack([col(v) for v in r], -1) for r in rows],
                       -2)


def _translate2(tx, ty):
    b, dev = tx.shape[0], tx.device
    return _mat([[1, 0, tx], [0, 1, ty], [0, 0, 1]], b, dev)


def _scale2(sx, sy):
    b, dev = sx.shape[0], sx.device
    return _mat([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], b, dev)


def _rotate2(t):
    b, dev = t.shape[0], t.device
    c, s = torch.cos(t), torch.sin(t)
    return _mat([[c, -s, 0], [s, c, 0], [0, 0, 1]], b, dev)


def _rotate3(axis, t):
    """Rotation by ``t`` about the unit ``axis`` (3,), 4x4 homogeneous."""
    b, dev = t.shape[0], t.device
    x, y, z = (float(a) for a in axis)
    c, s = torch.cos(t), torch.sin(t)
    k = 1 - c
    return _mat([[x * x * k + c, x * y * k - z * s, x * z * k + y * s, 0],
                 [y * x * k + z * s, y * y * k + c, y * z * k - x * s, 0],
                 [z * x * k - y * s, z * y * k + x * s, z * z * k + c, 0],
                 [0, 0, 0, 1]], b, dev)


# --- the shear warp ---------------------------------------------------------

def _upfirdn_1d(n_in, f, up, down, pad0, pad1, flip):
    """One separable upfirdn pass as a dense [n_out, n_in] matrix."""
    f = np.asarray(f, np.float64)
    if not flip:
        f = f[::-1]
    pad1 += up - 1
    span = (n_in - 1) * up + 1
    n_out = (span + pad0 + pad1 - len(f)) // down + 1
    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        for k, fk in enumerate(f):
            pos = o * down + k - pad0
            if 0 <= pos < span and pos % up == 0:
                m[o, pos // up] += fk
    return m


def _filters(n_pad, n_img, hz):
    """(up [2 n_pad, n_pad], down [n_img, 2 (n_img + 2 q)]) of one axis,
    q = taps // 4: the 2x up-filter with gain 2 and the 2x down-filter."""
    fw = len(hz)
    q = fw // 4
    up = _upfirdn_1d(n_pad, np.asarray(hz) * 2.0, 2, 1, (fw + 1) // 2,
                     (fw - 2) // 2, False)
    down = _upfirdn_1d(2 * (n_img + 2 * q), hz, 1, 2,
                       -2 * q + (fw - 1) // 2, -2 * q + (fw - 2) // 2, True)
    return (torch.from_numpy(up.astype(np.float32)),
            torch.from_numpy(down.astype(np.float32)))


def _centred(n, dev):
    return torch.arange(n, dtype=torch.float32, device=dev) - (n / 2 - 0.5)


def _tent(u, n_src):
    """[B, M, n_src]: bilinear weights at coordinates ``u`` [B, M]."""
    return torch.clamp_min(
        1.0 - torch.abs(u[:, :, None] - _centred(n_src, u.device)), 0.0)


def _shift(img, shift, axis):
    """Fractional shift of each line of ``img`` [B, C, R, N] along ``axis``
    (3: one shift per (B, R) row; 2: one per (B, N) column): linear
    interpolation between the two source taps, zeros outside."""
    length = img.shape[axis]
    s = torch.clamp(shift, -(length + 2), length + 2)
    k = torch.floor(s)
    f = s - k
    pos = torch.arange(length, device=img.device, dtype=torch.float32)
    if axis == 3:
        i0 = pos[None, None, :] + k[:, :, None]          # [B, R, N]
        f = f[:, :, None]
        view = lambda t: t[:, None].expand(-1, img.shape[1], -1, -1)
    else:
        i0 = pos[None, :, None] + k[:, None, :]          # [B, R, N]
        f = f[:, None, :]
        view = lambda t: t[:, None].expand(-1, img.shape[1], -1, -1)

    def tap(i):
        ok = (i >= 0) & (i < length)
        idx = view(torch.clamp(i, 0, length - 1).long())
        return torch.gather(img, axis, idx) * view(ok.to(img.dtype))
    return tap(i0) * view(1.0 - f) + tap(i0 + 1) * view(f)


def shear_warp(padded, a, t, hw, margin=1.0, q=lambda x: x):
    """The geometric operator on a reflect-padded square NHWC batch:
    ``a`` [B, 2, 2] and ``t`` [B, 2] are the inverse homography's linear
    and translation parts in centred pixels of the original image; ``q``
    rounds the operands of its matrix products."""
    b, hp, wp, c = padded.shape
    h, w = hw
    dev = padded.device
    hz = np.asarray(SYM6, np.float64)
    hz = (hz / hz.sum()).astype(np.float32).astype(np.float64)
    pad = len(hz) // 4
    out_h, out_w = 2 * (h + 2 * pad), 2 * (w + 2 * pad)
    up, down_x = _filters(wp, w, hz)
    _, down_y = _filters(hp, h, hz)
    up = up.to(dev)

    def round_up(v, m):
        return -(-v // m) * m
    vy = round_up(out_h + 2 * (math.ceil(margin * out_w / 2) + 2), 64)
    my = (vy - out_h) // 2
    vx = round_up(out_w + 2 * (math.ceil(margin * vy / 2) + 2), 128)
    mx = (vx - out_w) // 2

    # A = diag(sx, sy) ShearX(alpha) ShearY(gamma), on the image or on its
    # transpose, whichever needs the smaller shears
    a, t = a.detach().float(), t.detach().float()

    def safe(x):
        return torch.where(x.abs() < TINY, torch.where(x < 0, -TINY, TINY),
                           x)

    def shears(p_, q_, r_, s_):
        return q_ * safe(s_) / safe(p_ * s_ - q_ * r_), r_ / safe(s_)
    m00, m01, m10, m11 = a[:, 0, 0], a[:, 0, 1], a[:, 1, 0], a[:, 1, 1]
    al0, ga0 = shears(m00, m01, m10, m11)
    al1, ga1 = shears(m10, m11, m00, m01)
    swap = (torch.maximum(al1.abs(), ga1.abs())
            < torch.maximum(al0.abs(), ga0.abs()))
    pick = lambda u, v: torch.where(swap, u, v)
    aa, bb, cc, dd = (pick(m10, m00), pick(m11, m01), pick(m00, m10),
                      pick(m01, m11))
    tx, ty = pick(t[:, 1], t[:, 0]), pick(t[:, 0], t[:, 1])
    det, ds = safe(aa * dd - bb * cc), safe(dd)
    sx, sy, alpha, gamma = det / ds, dd, bb * ds / det, cc / ds

    img = torch.where(swap[:, None, None, None], padded.transpose(1, 2),
                      padded)
    ox = 0.5 * (aa + bb) + 2.0 * tx - 0.5
    oy = 0.5 * (cc + dd) + 2.0 * ty - 0.5
    rx = _tent(sx[:, None] * _centred(vx, dev) + ox[:, None], 2 * wp) @ up
    ry = _tent(sy[:, None] * _centred(vy, dev) + oy[:, None], 2 * hp) @ up
    v = torch.einsum("bmw,bhwc->bhmc", q(rx), q(img))
    v = torch.einsum("bnh,bhmc->bcnm", q(ry), q(v))         # [B, C, Vy, Vx]
    v = _shift(v, alpha[:, None] * _centred(vy, dev), 3)[..., mx:mx + out_w]
    v = _shift(v, gamma[:, None] * _centred(out_w, dev), 2)
    v = v[:, :, my:my + out_h]
    v = torch.einsum("hm,bcmw->bchw", q(down_y.to(dev)), q(v))
    return torch.einsum("wn,bchn->bhwc", q(down_x.to(dev)), q(v))


# --- the pipe ---------------------------------------------------------------

def bgc_pipe(draws, images, cfg: dict, p, q=lambda x: x) -> torch.Tensor:
    """Augment an NHWC batch in [-1, 1] with probability ``p`` (a float or
    0-d tensor).  ``cfg`` holds the policy's multipliers and ranges under
    the configuration's names; a transform whose multiplier is 0 draws
    nothing.  ``q`` rounds the operands of the warp's and the color
    transform's matrix products."""
    b, h, w, c = images.shape
    dev = images.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev).detach()
    rand = lambda *s: draws.uniform(s).to(dev, torch.float32)
    randn = lambda *s: draws.normal(s).to(dev, torch.float32)

    def gated(value, prob, identity):
        keep = rand(*((b,) + (1,) * (value.ndim - 1))) < prob
        return torch.where(keep, value, torch.full_like(value, identity))
    on = lambda k: cfg.get(k, 0) > 0
    one = torch.ones(b, device=dev)

    g = torch.eye(3, device=dev).repeat(b, 1, 1)
    if on("xflip"):
        i = gated(torch.floor(rand(b) * 2), cfg["xflip"] * p, 0.0)
        g = g @ _scale2(1 - 2 * i, one)
    if on("rotate90"):
        i = gated(torch.floor(rand(b) * 4), cfg["rotate90"] * p, 0.0)
        g = g @ _rotate2(math.pi / 2 * i)
    if on("xint"):
        s = gated((rand(b, 2) * 2 - 1) * cfg["xint_max"], cfg["xint"] * p,
                  0.0)
        g = g @ _translate2(-torch.round(s[:, 0] * w),
                            -torch.round(s[:, 1] * h))
    if on("scale"):
        s = gated(torch.exp2(randn(b) * cfg["scale_std"]), cfg["scale"] * p,
                  1.0)
        g = g @ _scale2(1 / s, 1 / s)
    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.get("rotate", 0) * p, 0, 1))
    if on("rotate"):
        r = gated((rand(b) * 2 - 1) * math.pi * cfg["rotate_max"], p_rot,
                  0.0)
        g = g @ _rotate2(r)
    if on("aniso"):
        s = gated(torch.exp2(randn(b) * cfg["aniso_std"]), cfg["aniso"] * p,
                  1.0)
        g = g @ _scale2(1 / s, s)
    if on("rotate"):
        r = gated((rand(b) * 2 - 1) * math.pi * cfg["rotate_max"], p_rot,
                  0.0)
        g = g @ _rotate2(r)
    if on("xfrac"):
        s = gated(randn(b, 2) * cfg["xfrac_std"], cfg["xfrac"] * p, 0.0)
        g = g @ _translate2(-s[:, 0] * w, -s[:, 1] * h)

    if any(on(k) for k in ("xflip", "rotate90", "xint", "scale", "rotate",
                           "aniso", "xfrac")):
        if h != w:
            raise ValueError("the shear warp takes square images")
        padded = F.pad(images.permute(0, 3, 1, 2), (w - 1, w - 1, h - 1,
                                                     h - 1), mode="reflect")
        images = shear_warp(padded.permute(0, 2, 3, 1), g[:, :2, :2],
                            g[:, :2, 2], (h, w), cfg.get("shear_margin", 1.0),
                            q)

    v = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)
    vv = torch.outer(v, v)
    eye4 = torch.eye(4, device=dev)
    m = eye4.repeat(b, 1, 1)
    color = False
    if on("brightness"):
        t = gated(randn(b) * cfg["brightness_std"], cfg["brightness"] * p,
                  0.0)
        m = _mat([[1, 0, 0, t], [0, 1, 0, t], [0, 0, 1, t], [0, 0, 0, 1]],
                 b, dev) @ m
        color = True
    if on("contrast"):
        s = gated(torch.exp2(randn(b) * cfg["contrast_std"]),
                  cfg["contrast"] * p, 1.0)
        m = _mat([[s, 0, 0, 0], [0, s, 0, 0], [0, 0, s, 0], [0, 0, 0, 1]],
                 b, dev) @ m
        color = True
    if on("lumaflip"):
        i = gated(torch.floor(rand(b, 1, 1) * 2), cfg["lumaflip"] * p, 0.0)
        m = (eye4 - 2 * vv * i) @ m
        color = True
    if on("hue"):
        r = gated((rand(b) * 2 - 1) * math.pi * cfg["hue_max"],
                  cfg["hue"] * p, 0.0)
        m = _rotate3([1 / math.sqrt(3)] * 3, r) @ m
        color = True
    if on("saturation"):
        s = gated(torch.exp2(randn(b, 1, 1) * cfg["saturation_std"]),
                  cfg["saturation"] * p, 1.0)
        m = (vv + (eye4 - vv) * s) @ m
        color = True
    if color:
        flat = images.reshape(b, h * w, c).float()
        flat = q(flat) @ q(m[:, :3, :3].transpose(1, 2)) + m[:, None, :3, 3]
        images = flat.reshape(b, h, w, c)
    for k in ("imgfilter", "noise", "cutout"):
        if on(k):
            raise ValueError(f"the bgc reference has no {k} transform")
    return images.contiguous()
