"""Kernel W: the resampling passes of the ADA shear warp as bands.

The gather-free warp (``pgx_torch.ops.warp``) reflect-pads the image, blits
its transpose where a sample's affine is closer to a 90-degree turn (pass
0), resamples it on a 2x-supersampled grid (pass 1: bilinear tent times the
sym6 up-filter, per axis), shears it twice (passes 2/3, kernel F) and
filters it back down by 2 (pass 4).  ``pgx/ops/warp.py`` computes passes 1
and 4 as dense matrix products over matrices it builds at every call, and
leaves them to XLA: there is no Pallas kernel to replace.  Each output of
those products reads at most 7 input pixels per axis (two tent taps on the
2x grid, six taps of the up-filter each), so kernel W computes them as
bands:

- **W1** ``warp_resample(img, params, vy, vx, taps)``: passes 0 and 1 with
  the reflect pad folded in.  ``img`` is the *unpadded* NHWC image ``[B, H,
  H, C]`` (square, C <= 3), padded on the fly by ``H - 1`` on every side
  (numpy's "reflect", the pipe's static margin); ``params`` ``[B, 5]`` f32
  holds each sample's ``swap, sx, sy, t_x, t_y`` (``warp._decompose``);
  the result is ``[B, C, vy, vx]``, what kernel F's x-shear reads.
- **W2** ``warp_down2(v, taps)``: pass 4, ``[B, C, 2H + 12, 2W + 12]`` (the
  y-shear's row crop, read in place by its strides) to NHWC ``[B, H, W, C]``.

Bound: bytes.  W1 writes ``B C vy vx`` elements (at 512px, batch 8, f32:
649 MB, 0.19 ms at 3.35 TB/s) and reads the image (25 MB) from L2; W2 reads
the crop once and writes a quarter of it.  The dense products cost 162
GFLOP an image at 512px, on CUDA cores for f32 images.

Design (``csrc/warp_resample.cu``): W1's block owns a 32 x 32 tile of
outputs; it computes the tile's bands, stages the padded patch they read in
shared memory (reflection and transpose resolved at the load), resamples
along x into shared memory and along y into the output.  W2 filters a staged
window along x and then y.  Accumulation is in f32 with one rounding at the
store, and the weights are f32 for every image type: the dense route rounded
its matrices and its x-to-y intermediate to bf16 for bf16 images.

Differentiation: each op is linear in its tensor input and has a transpose
kernel in gather form, deterministic and free of atomics (W1's folds the
reflect pad: each pixel sums its at most 3 x 3 mirrored positions).  The
``autograd.Function`` of each op applies the other as its backward, so the
warp differentiates to any order.  ``params`` gets no gradient: it derives
from random draws only.

CPU tensors take the plain versions, which are pgx's arithmetic (``F.pad``
and the einsums over ``_tent_matrix`` x U2, D2); CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels import build

NAME, NAME_T = "warp_resample", "warp_resample_t"
NAME_DOWN, NAME_DOWN_T = "warp_down2", "warp_down2_t"
# csrc/warp_resample.cu's filter length and the most channels it takes
TAPS, MAX_C = 12, 3


# ---------------------------------------------------------------------------
# The plain versions: pgx/ops/warp.py's matrices and einsums
# ---------------------------------------------------------------------------

def upfirdn_matrix_1d(n_in: int, f, up: int = 1, down: int = 1,
                      pad0: int = 0, pad1: int = 0,
                      flip_filter: bool = False) -> np.ndarray:
    """Dense matrix of one separable upfirdn pass (numpy, static),
    including the filter flip and the trailing ``up - 1`` zero-stuffing
    pad.  Returns [n_out, n_in] float64."""
    f = np.asarray(f, np.float64).reshape(-1)
    if not flip_filter:
        f = f[::-1]
    pad1 = pad1 + (up - 1)
    dil_len = (n_in - 1) * up + 1
    total = dil_len + pad0 + pad1
    n_out = (total - len(f)) // down + 1
    m = np.zeros((n_out, n_in))
    ks = np.arange(len(f))
    for o in range(n_out):
        pos = o * down + ks - pad0
        sel = (pos >= 0) & (pos < dil_len) & (pos % up == 0)
        m[o, pos[sel] // up] += f[sel]
    return m


@functools.lru_cache(maxsize=None)
def _static_matrices(n_pad: int, n_img: int, hz: Tuple[float, ...]):
    """(U2 [2*n_pad, n_pad], D2 [n_img, out_n]) for one axis, as numpy f32.

    U2 reproduces ``upsample2d(x, hz, up=2)`` (gain 4, so sqrt-gain 2 per
    axis); D2 reproduces ``downsample2d(x, hz, down=2, padding=-2*hz_pad,
    flip_filter=True)``: the calls the gather path of the pipe makes."""
    f = np.asarray(hz, np.float64)
    fw = f.shape[0]
    hz_pad = fw // 4
    up_m = upfirdn_matrix_1d(n_pad, f * 2.0, up=2, down=1,
                             pad0=(fw + 1) // 2, pad1=(fw - 2) // 2,
                             flip_filter=False)
    out_n = 2 * (n_img + 2 * hz_pad)
    dn_m = upfirdn_matrix_1d(out_n, f, up=1, down=2,
                             pad0=-2 * hz_pad + (fw - 1) // 2,
                             pad1=-2 * hz_pad + (fw - 2) // 2,
                             flip_filter=True)
    assert up_m.shape == (2 * n_pad, n_pad)
    assert dn_m.shape == (n_img, out_n), dn_m.shape
    return up_m.astype(np.float32), dn_m.astype(np.float32)


def _centered(n: int, device=None) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device)
            - (n / 2 - 0.5))


def _tent_matrix(u: torch.Tensor, n_src: int) -> torch.Tensor:
    """[B, M, n_src] bilinear-interpolation matrix at coords ``u`` [B, M]
    (source pixels at centered coordinates, zero outside)."""
    kc = _centered(n_src, u.device)
    return torch.clamp_min(
        1.0 - torch.abs(u[:, :, None] - kc[None, None, :]), 0.0)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """The image index of each position of numpy's "reflect" pad of a
    size-``n`` axis by ``pad < n`` on each side."""
    x = torch.abs(torch.arange(n + 2 * pad, device=device) - pad)
    return torch.where(x >= n, 2 * (n - 1) - x, x)


def _band_matrices(params: torch.Tensor, vy: int, vx: int, n: int,
                   taps: Sequence[float]):
    """W1's dense resampling matrices ``(X [B, vx, n_pad], Y [B, vy,
    n_pad])``, f32: the tent at each output's position times U2."""
    n_pad = 3 * n - 2
    hz = tuple(float(t) for t in taps)
    dev = params.device
    u2 = torch.from_numpy(_static_matrices(n_pad, n, hz)[0]).to(dev)
    sx, sy, t_x, t_y = params[:, 1:].to(torch.float32).unbind(1)
    ux = sx[:, None] * _centered(vx, dev)[None, :] + t_x[:, None]
    uy = sy[:, None] * _centered(vy, dev)[None, :] + t_y[:, None]
    return (torch.einsum("bmk,kw->bmw", _tent_matrix(ux, 2 * n_pad), u2),
            torch.einsum("bmk,kh->bmh", _tent_matrix(uy, 2 * n_pad), u2))


def _swap(params: torch.Tensor) -> torch.Tensor:
    return (params[:, 0] != 0)[:, None, None, None]


def warp_resample_ref(img: torch.Tensor, params: torch.Tensor, vy: int,
                      vx: int, taps: Sequence[float]) -> torch.Tensor:
    """Plain version of W1: the reflect pad (``F.pad``), the conditional
    transpose, and the two resampling einsums; contiguous, as the kernel's
    output."""
    _check_image(NAME, img, taps)
    n = img.shape[1]
    padded = F.pad(img.permute(0, 3, 1, 2), (n - 1,) * 4,
                   mode="reflect").permute(0, 2, 3, 1)
    padded = torch.where(_swap(params), padded.transpose(1, 2), padded)
    mx_mat, my_mat = _band_matrices(params, vy, vx, n, taps)
    dt = padded.dtype
    v = torch.einsum("bmw,bhwc->bhmc", mx_mat.to(dt), padded)
    # land in [B, C, Vy, Vx]: the shifts run along the minor axis
    return torch.einsum("bnh,bhmc->bcnm", my_mat.to(dt), v).contiguous()


def warp_resample_t_ref(grad: torch.Tensor, params: torch.Tensor, n: int,
                        taps: Sequence[float]) -> torch.Tensor:
    """Plain version of W1's transpose: the einsums transposed, the
    transpose undone, and each padded position added to its pixel."""
    vy, vx = grad.shape[2:]
    mx_mat, my_mat = _band_matrices(params, vy, vx, n, taps)
    dt = grad.dtype
    t = torch.einsum("bnh,bcnm->bhmc", my_mat.to(dt), grad)
    gp = torch.einsum("bmw,bhmc->bhwc", mx_mat.to(dt), t)
    gp = torch.where(_swap(params), gp.transpose(1, 2), gp)
    idx = _reflect_index(n, n - 1, grad.device)
    b, _, n_pad, c = gp.shape
    rows = gp.new_zeros((b, n, n_pad, c)).index_add_(1, idx, gp)
    return gp.new_zeros((b, n, n, c)).index_add_(2, idx, rows)


def _down_matrices(h: int, w: int, taps: Sequence[float], like):
    hz = tuple(float(t) for t in taps)
    return tuple(torch.from_numpy(_static_matrices(3 * n - 2, n, hz)[1]).to(
        device=like.device, dtype=like.dtype) for n in (h, w))


def _down_size(v_shape, taps) -> Tuple[int, int]:
    hz_pad = len(taps) // 4
    return v_shape[2] // 2 - 2 * hz_pad, v_shape[3] // 2 - 2 * hz_pad


def warp_down2_ref(v: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Plain version of W2: the two static down-filter einsums."""
    d2y, d2x = _down_matrices(*_down_size(v.shape, taps), taps, v)
    v = torch.einsum("hm,bcmw->bchw", d2y, v)
    return torch.einsum("wn,bchn->bhwc", d2x, v).contiguous()


def warp_down2_t_ref(g: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Plain version of W2's transpose."""
    d2y, d2x = _down_matrices(g.shape[1], g.shape[2], taps, g)
    t = torch.einsum("wn,bhwc->bchn", d2x, g)
    return torch.einsum("hm,bchn->bcmn", d2y, t).contiguous()


def _check_image(name: str, img: torch.Tensor, taps) -> None:
    if img.ndim != 4 or img.shape[1] != img.shape[2]:
        raise ValueError(f"{name}: expected a square NHWC image, got "
                         f"{tuple(img.shape)}")
    if len(taps) != TAPS:
        raise ValueError(f"{name}: {len(taps)} filter taps; the pipe's sym6 "
                         f"has {TAPS}")


# ---------------------------------------------------------------------------
# The kernels' launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, once it has shown the filter length and channel
    limit this module assumes."""
    lib = build.load_library()
    got = tuple(lib.pgx_warp_resample_limits(i) for i in range(2))
    if got != (TAPS, MAX_C):
        raise RuntimeError(f"{NAME}: csrc/warp_resample.cu's limits {got} "
                           f"differ from warp_resample.py's {(TAPS, MAX_C)}")
    return lib


@functools.lru_cache(maxsize=16)
def _host_taps(taps: Tuple[float, ...]):
    """The taps as a C array of floats on the host, kept alive by the
    cache; the kernel takes them by value."""
    return (ctypes.c_float * len(taps))(*taps)


def _check_cuda(name: str, c: int, taps) -> None:
    if len(taps) != TAPS:
        raise ValueError(f"{name}: {len(taps)} filter taps, the kernel "
                         f"takes {TAPS}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"{name}: {c} channels, the kernel takes 1 to "
                         f"{MAX_C}")


def _params_on(params: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return params.to(device=like.device, dtype=torch.float32).contiguous()


def _launch(img, params, vy, vx, taps):
    _check_image(NAME, img, taps)
    img = build.aligned(img.contiguous())
    build.check_cuda_input(NAME, img)
    b, n, _, c = img.shape
    _check_cuda(NAME, c, taps)
    p = _params_on(params, img)
    out = torch.empty((b, c, vy, vx), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    hz = _host_taps(tuple(taps))
    build.check(_library().pgx_warp_resample(
        img.data_ptr(), p.data_ptr(), out.data_ptr(), b, n, c, vy, vx,
        ctypes.addressof(hz), build.dtype_code(img), build.stream_ptr()),
        NAME)
    build.LAUNCHES[NAME] += 1
    return out


def _launch_t(grad, params, n, taps):
    grad = build.aligned(grad.contiguous())
    build.check_cuda_input(NAME_T, grad)
    b, c, vy, vx = grad.shape
    _check_cuda(NAME_T, c, taps)
    p = _params_on(params, grad)
    out = torch.empty((b, n, n, c), dtype=grad.dtype, device=grad.device)
    if out.numel() == 0:
        return out
    hz = _host_taps(tuple(taps))
    build.check(_library().pgx_warp_resample_t(
        grad.data_ptr(), p.data_ptr(), out.data_ptr(), b, n, c, vy, vx,
        ctypes.addressof(hz), build.dtype_code(grad), build.stream_ptr()),
        NAME_T)
    build.LAUNCHES[NAME_T] += 1
    return out


def _launch_down(v, taps):
    if v.stride(-1) != 1 or v.data_ptr() % 4:
        v = build.aligned(v.contiguous())
    build.check_cuda_input(NAME_DOWN, v, rows_strided=True)
    b, c = v.shape[:2]
    h, w = _down_size(v.shape, taps)
    _check_cuda(NAME_DOWN, c, taps)
    out = torch.empty((b, h, w, c), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    hz = _host_taps(tuple(taps))
    sb, sc, sr, _ = v.stride()
    build.check(_library().pgx_warp_down2(
        v.data_ptr(), out.data_ptr(), b, c, h, w, sb, sc, sr,
        ctypes.addressof(hz), build.dtype_code(v), build.stream_ptr()),
        NAME_DOWN)
    build.LAUNCHES[NAME_DOWN] += 1
    return out


def _launch_down_t(g, taps):
    g = build.aligned(g.contiguous())
    build.check_cuda_input(NAME_DOWN_T, g)
    b, h, w, c = g.shape
    _check_cuda(NAME_DOWN_T, c, taps)
    out = torch.empty(_down_t_shape(g, taps), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    hz = _host_taps(tuple(taps))
    build.check(_library().pgx_warp_down2_t(
        g.data_ptr(), out.data_ptr(), b, c, h, w, ctypes.addressof(hz),
        build.dtype_code(g), build.stream_ptr()), NAME_DOWN_T)
    build.LAUNCHES[NAME_DOWN_T] += 1
    return out


def _down_shape(v, taps):
    return (v.shape[0], *_down_size(v.shape, taps), v.shape[1])


def _down_t_shape(g, taps):
    hz_pad = len(taps) // 4
    b, h, w, c = g.shape
    return (b, c, 2 * (h + 2 * hz_pad), 2 * (w + 2 * hz_pad))


op = build.define_op(
    f"{NAME}(Tensor img, Tensor params, int vy, int vx, float[] taps) "
    f"-> Tensor",
    cpu=lambda img, params, vy, vx, taps: warp_resample_ref(
        img, params, vy, vx, taps),
    cuda=lambda img, params, vy, vx, taps: _launch(img, params, vy, vx,
                                                   taps),
    fake=lambda img, params, vy, vx, taps: img.new_empty(
        (img.shape[0], img.shape[3], vy, vx)))

transpose_op = build.define_op(
    f"{NAME_T}(Tensor grad, Tensor params, int n, float[] taps) -> Tensor",
    cpu=lambda grad, params, n, taps: warp_resample_t_ref(grad, params, n,
                                                          taps),
    cuda=lambda grad, params, n, taps: _launch_t(grad, params, n, taps),
    fake=lambda grad, params, n, taps: grad.new_empty(
        (grad.shape[0], n, n, grad.shape[1])))

down_op = build.define_op(
    f"{NAME_DOWN}(Tensor v, float[] taps) -> Tensor",
    cpu=lambda v, taps: warp_down2_ref(v, taps),
    cuda=lambda v, taps: _launch_down(v, taps),
    fake=lambda v, taps: v.new_empty(_down_shape(v, taps)))

down_transpose_op = build.define_op(
    f"{NAME_DOWN_T}(Tensor g, float[] taps) -> Tensor",
    cpu=lambda g, taps: warp_down2_t_ref(g, taps),
    cuda=lambda g, taps: _launch_down_t(g, taps),
    fake=lambda g, taps: g.new_empty(_down_t_shape(g, taps)))


# ---------------------------------------------------------------------------
# Differentiation: each op's backward is the other
# ---------------------------------------------------------------------------

class _Resample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, params, vy, vx, taps):
        ctx.save_for_backward(params)
        ctx.shape = (img.shape[1], vy, vx, taps)
        return op(img, params, vy, vx, taps)

    @staticmethod
    def backward(ctx, g):
        params, = ctx.saved_tensors
        n, vy, vx, taps = ctx.shape
        return (_ResampleT.apply(g, params, n, vy, vx, taps), None, None,
                None, None)


class _ResampleT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad, params, n, vy, vx, taps):
        ctx.save_for_backward(params)
        ctx.shape = (vy, vx, taps)
        return transpose_op(grad, params, n, taps)

    @staticmethod
    def backward(ctx, g):
        params, = ctx.saved_tensors
        vy, vx, taps = ctx.shape
        return (_Resample.apply(g, params, vy, vx, taps), None, None, None,
                None, None)


class _Down2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, taps):
        ctx.taps = taps
        return down_op(v, taps)

    @staticmethod
    def backward(ctx, g):
        return _Down2T.apply(g, ctx.taps), None


class _Down2T(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, taps):
        ctx.taps = taps
        return down_transpose_op(g, taps)

    @staticmethod
    def backward(ctx, gg):
        return _Down2.apply(gg, ctx.taps), None


def warp_resample(img: torch.Tensor, params: torch.Tensor, vy: int, vx: int,
                  taps: Sequence[float]) -> torch.Tensor:
    """Passes 0 and 1 of the shear warp on the unpadded square NHWC
    ``img``: ``[B, C, vy, vx]`` on the 2x grid, differentiable in ``img``
    to any order; ``params`` ``[B, 5]`` (swap, sx, sy, t_x, t_y) is
    detached."""
    _check_image(NAME, img, taps)
    return _Resample.apply(img, params.detach(), int(vy), int(vx),
                           tuple(float(t) for t in taps))


def warp_down2(v: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Pass 4 of the shear warp: ``[B, C, 2H + 12, 2W + 12]`` (a view with
    strided rows is read in place) to NHWC ``[B, H, W, C]``,
    differentiable to any order."""
    if v.ndim != 4:
        raise ValueError(f"{NAME_DOWN}: expected [B, C, R, S], got "
                         f"{tuple(v.shape)}")
    return _Down2.apply(v, tuple(float(t) for t in taps))
