"""Kernel D: separable upfirdn2d (pad or crop, zero-stuff by ``up``, 1-D
FIR, decimate by ``down``) on NHWC tensors.

Replaces ``pgx/ops/pallas/kernels.py:upfirdn2d_pallas``.  Per axis, with
``taps`` the filter scaled by ``sqrt(gain)`` and flipped unless
``flip_filter`` (a true convolution by default)::

    out[j] = sum_t taps[t] * d[j*down + t - pad0]
    d[p]   = x[p/up] where p >= 0, p % up == 0 and p/up < L, else 0
    n_out  = (L*up + pad0 + pad1 - ntaps) // down + 1

so the zero-stuffed signal carries the trailing ``up - 1`` zeros and
negative padding crops.  Sums are taken in f32 (f64 for an f64 input) and
rounded once per pass, H first, then W.

Bound: bytes.  The CUDA kernel (``csrc/upfirdn2d.cu``) is one launch per
call: a block stages the input window of one output tile in shared memory,
runs the H pass and the W pass there and writes the tile.  ``_plan`` picks
the tile and its window; the kernel is launched with the plan's numbers.

The op ``torch.ops.pgx_torch.upfirdn2d`` (``build.define_op``) launches the
kernel for CUDA tensors, with the plan made from its integer and float-list
arguments there, and takes the plain version for CPU tensors.

Differentiation.  The op is linear in ``x`` and its transpose is an
upfirdn with ``up`` and ``down`` swapped, the filter flipped the other way
and the padding of the reference's backward (``p0' = ntaps - p0 - 1``,
``p1' = L*up - n_out*down + p0 - up + 1`` per axis), so the Function's
backward applies the Function itself: on a card it launches kernel D once
more, and it differentiates again.  pgx takes the VJP of its lax
formulation instead; the gradients are the same linear map.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels import build

NAME = "upfirdn2d"
Pads = Tuple[int, int, int, int]          # (px0, px1, py0, py1)


def out_len(length: int, ntaps: int, up: int, down: int, pad0: int,
            pad1: int) -> int:
    return max((length * up + pad0 + pad1 - ntaps) // down + 1, 0)


def _oriented(taps: Sequence[float], flip_filter: bool) -> Tuple[float, ...]:
    """Taps in correlation order: flipped for a true convolution."""
    taps = tuple(float(t) for t in taps)
    return taps if flip_filter else taps[::-1]


def _pass_ref(x: torch.Tensor, taps: Tuple[float, ...], axis: int, up: int,
              down: int, pad0: int, pad1: int) -> torch.Tensor:
    """One pass along H (axis 1) or W (axis 2) of NHWC ``x`` in plain ops;
    ``taps`` in correlation order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    v = x.to(acc).movedim(axis, -1)                   # [..., L]
    if up > 1:                                        # zero-stuff
        v = torch.stack([v] + [torch.zeros_like(v)] * (up - 1), dim=-1)
        v = v.reshape(*v.shape[:-2], -1)
    v = F.pad(v, (max(pad0, 0), max(pad1, 0)))
    v = v[..., max(-pad0, 0):v.shape[-1] - max(-pad1, 0)]
    n = v.shape[-1] - len(taps) + 1
    if n <= 0:
        out = v.new_zeros(*v.shape[:-1], 0)
    else:
        k = torch.tensor(taps, dtype=acc, device=x.device)
        out = F.conv1d(v.reshape(-1, 1, v.shape[-1]), k[None, None])
        out = out.reshape(*v.shape[:-1], n)[..., ::down]
    return out.movedim(-1, axis).to(x.dtype)


def upfirdn2d_ref(x: torch.Tensor, taps: Sequence[float], up: int = 1,
                  down: int = 1, pads: Pads = (0, 0, 0, 0),
                  flip_filter: bool = False) -> torch.Tensor:
    """Plain PyTorch version: H pass then W pass with the 1-D ``taps``
    (already scaled by ``sqrt(gain)``)."""
    px0, px1, py0, py1 = pads
    t = _oriented(taps, flip_filter)
    y = _pass_ref(x, t, 1, up, down, py0, py1)
    return _pass_ref(y, t, 2, up, down, px0, px1).contiguous()


# ---------------------------------------------------------------------------
# The tile plan: what the kernel is launched with
# ---------------------------------------------------------------------------

RUN = 8                  # outputs per thread item in each pass (csrc kRun)
MAX_TAPS = 64
SMEM_MAX = 232_448       # shared memory a block may use on Hopper
SMEM_TARGET = 110_000    # a default tile leaves room for two blocks per SM
C_TILE_MAX = 64          # channels per tile; more are split into chunks
# default (tile_h, tile_w) by (C <= 8, down): the fastest of a sweep of
# tiles at the gather warp's and the ops block's shapes on an H100
DEFAULT_TILES = {(True, 1): (32, 128), (True, 2): (32, 32),
                 (False, 1): (16, 16), (False, 2): (16, 16)}


class _PlanC(ctypes.Structure):
    """One launch: ``struct Plan`` of ``csrc/upfirdn2d.cu``, field for field.
    Tile (ty, tx) of image b and channel chunk ch computes the output rows
    and columns of :func:`_tile` and channels ``ch * tile_c + [0, tile_c)``
    from the input window of :func:`_window`.  Shared memory holds the
    window's ``win_h`` rows of ``win_w * tile_c`` elements, ``in_pitch``
    apart, at 0 (with all of C, copied from x in units of ``stage_vec``
    elements, which divide x's row), the H pass's rows ``[tile_h][win_w *
    tile_c]`` at ``off_mid``, the tile's outputs in ``tile_h * seg_n``
    segments of ``seg_pitch`` elements at ``off_out`` (a segment is a tile
    row, or one pixel's chunk when C is split) and the taps at
    ``off_taps``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "h", "w", "c", "oh", "ow", "up", "down", "ntaps", "pad_y",
        "pad_x", "org_y", "org_x", "tile_h", "tile_w", "tile_c", "win_h",
        "win_w", "in_pitch", "stage_vec", "tiles_y", "tiles_x", "chunks",
        "seg_n", "seg_pitch", "vec",
        "off_mid", "off_out", "off_taps", "smem_bytes")] + [
        ("taps", ctypes.c_float * MAX_TAPS)]


def _tile(p: _PlanC, ty: int, tx: int) -> Tuple[range, range]:
    """Output rows and columns tile (ty, tx) computes, those past the
    output's edges included (the kernel stores none of them)."""
    j0 = ty * p.tile_h + p.org_y
    i0 = tx * p.tile_w + p.org_x
    return range(j0, j0 + p.tile_h), range(i0, i0 + p.tile_w)


def _window(p: _PlanC, ty: int, tx: int) -> Tuple[range, range]:
    """Input rows and columns tile (ty, tx) stages, from ``floor((j0 * down
    - pad0) / up)`` on, as the kernel computes them."""
    rows, cols = _tile(p, ty, tx)
    r0 = (rows[0] * p.down - p.pad_y) // p.up
    c0 = (cols[0] * p.down - p.pad_x) // p.up
    return range(r0, r0 + p.win_h), range(c0, c0 + p.win_w)


@functools.lru_cache(maxsize=256)
def _launch_args(shape: Tuple[int, int, int, int], taps: Tuple[float, ...],
                 up: int, down: int, pads: Pads,
                 dtype: torch.dtype) -> _PlanC:
    """The plan of a call with its taps, made once per shape and filter:
    making it takes tens of microseconds, longer than a small launch."""
    plan = _plan(shape, len(taps), up, down, pads, dtype)
    plan.taps[:len(taps)] = taps
    return plan


def _axis_plan(n_out: int, ntaps: int, up: int, down: int, pad0: int,
               tile: int) -> Tuple[int, int, int]:
    """(origin, window, tiles) along one axis.  For up = 2, down = 1 the
    tiles start one output early where pad0 is odd, so that tap 0 of every
    thread's first output meets a sample (phase 0), as the kernel's
    fixed-count instantiations assume; that extra output is not stored."""
    org = -(pad0 % 2) if (up, down) == (2, 1) else 0
    phase = (org * down - pad0) % up
    win = (phase + (tile - 1) * down + ntaps - 1) // up + 1
    return org, win, -(-(n_out - org) // tile)


def _layout(th: int, tw: int, ct: int, w: int, c: int, wh: int, ww: int,
            es: int) -> Tuple[Tuple[int, int], Tuple[int, ...]]:
    """((in_pitch, stage_vec), (seg_n, seg_pitch, vec, off_mid, off_out,
    off_taps, smem_bytes)).  A staged row and an output segment each have
    room for the elements ahead of their first one that let them sit at
    their place in x or ``out`` modulo the unit they are copied in."""
    vec = 16 // es

    def up_to(n, m):
        return -(-n // m) * m

    in_pitch = up_to(ww * ct + 2 * vec - 2, vec)
    stage_vec = 1
    while ct == c and stage_vec < vec and (w * c) % (2 * stage_vec) == 0:
        stage_vec *= 2
    seg_n, cap = (1, tw * c) if ct == c else (tw, ct)
    pitch = up_to(cap + vec - 1, vec)
    off_mid = up_to(wh * in_pitch * es, 16)
    off_out = off_mid + up_to(th * ww * ct * es, 16)
    off_taps = off_out + up_to(th * seg_n * pitch * es, 16)
    return (in_pitch, stage_vec), (seg_n, pitch, vec, off_mid, off_out,
                                   off_taps, off_taps + 4 * MAX_TAPS)


def _tile_plan(shape: Tuple[int, int, int, int], ntaps: int, up: int,
               down: int, pads: Pads, dtype: torch.dtype,
               tile: Tuple[int, int, int]) -> _PlanC:
    """The plan of one call (NHWC ``shape``, ``ntaps`` taps, ``pads = (px0,
    px1, py0, py1)``) with ``tile = (tile_h, tile_w, tile_c)``."""
    b, h, w, c = shape
    px0, px1, py0, py1 = pads
    th, tw, ct = tile
    if th % RUN or tw % RUN or th < RUN or tw < RUN or not 1 <= ct <= c:
        raise ValueError(f"{NAME}: tile {tile}: tile_h and tile_w must be "
                         f"multiples of {RUN}, 1 <= tile_c <= C")
    oh = out_len(h, ntaps, up, down, py0, py1)
    ow = out_len(w, ntaps, up, down, px0, px1)
    org_y, wh, tiles_y = _axis_plan(oh, ntaps, up, down, py0, th)
    org_x, ww, tiles_x = _axis_plan(ow, ntaps, up, down, px0, tw)
    stage, out = _layout(th, tw, ct, w, c, wh, ww, dtype.itemsize)
    return _PlanC(b, h, w, c, oh, ow, up, down, ntaps, py0, px0, org_y,
                  org_x, th, tw, ct, wh, ww, *stage, tiles_y, tiles_x,
                  -(-c // ct), *out)


def _plan(shape: Tuple[int, int, int, int], ntaps: int, up: int, down: int,
          pads: Pads, dtype: torch.dtype) -> _PlanC:
    """The tile plan of one call, taps not filled in: the tile of ``DEFAULT_TILES`` with all of
    C up to ``C_TILE_MAX`` channels, no larger than the output, shrunk
    (width and height, then channels) until its shared memory fits
    ``SMEM_TARGET``."""
    def runs(n):                  # a multiple of RUN, at least RUN
        return max(RUN, n // RUN * RUN)

    def make(tile):
        return _tile_plan(shape, ntaps, up, down, pads, dtype, tile)

    oh = out_len(shape[1], ntaps, up, down, pads[2], pads[3])
    ow = out_len(shape[2], ntaps, up, down, pads[0], pads[1])
    ct = min(shape[3], C_TILE_MAX)
    th, tw = DEFAULT_TILES[(ct <= 8, down)]
    th, tw = runs(min(th, oh + RUN)), runs(min(tw, ow + RUN))
    plan = make((th, tw, ct))
    while plan.smem_bytes > SMEM_TARGET and (th, tw, ct) != (RUN, RUN, 1):
        if max(th, tw) > RUN:
            if tw >= th:
                tw = runs(tw // 2)
            else:
                th = runs(th // 2)
        else:
            ct = -(-ct // 2)
        plan = make((th, tw, ct))
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"{NAME}: the plan for {shape}, {ntaps} taps needs "
                         f"{plan.smem_bytes} bytes of shared memory, more "
                         f"than {SMEM_MAX}")
    return plan


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, once it has shown that its struct Plan has
    ``_PlanC``'s size."""
    lib = build.load_library()
    if lib.pgx_upfirdn2d_plan_bytes() != ctypes.sizeof(_PlanC):
        raise RuntimeError(f"{NAME}: csrc/upfirdn2d.cu's struct Plan differs "
                           f"from upfirdn2d.py's _PlanC")
    return lib


def _launch(x: torch.Tensor, taps: Sequence[float], up: int, down: int,
            pads: Pads, flip_filter: bool) -> torch.Tensor:
    x = build.aligned(x)
    build.check_cuda_input(NAME, x)
    if up not in (1, 2) or down not in (1, 2):
        raise ValueError(f"{NAME}: up and down must be 1 or 2, got "
                         f"{up}, {down}")
    t = _oriented(taps, flip_filter)
    if not 1 <= len(t) <= MAX_TAPS:
        raise ValueError(f"{NAME}: {len(t)} taps, the kernel takes 1 to "
                         f"{MAX_TAPS}")
    plan = _launch_args(tuple(x.shape), t, up, down, pads, x.dtype)
    out = torch.empty((plan.batch, plan.oh, plan.ow, plan.c), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    build.check(lib.pgx_upfirdn2d(
        x.data_ptr(), out.data_ptr(), ctypes.byref(plan),
        build.dtype_code(x), build.stream_ptr()), NAME)
    build.LAUNCHES[NAME] += 1
    return out


def _fake(x, taps, up, down, pads, flip_filter):
    """The output of a call, empty: for fake and meta tensors."""
    px0, px1, py0, py1 = pads
    n = len(taps)
    return x.new_empty((x.shape[0], out_len(x.shape[1], n, up, down, py0, py1),
                        out_len(x.shape[2], n, up, down, px0, px1),
                        x.shape[3]))


op = build.define_op(
    f"{NAME}(Tensor x, float[] taps, int up, int down, int[4] pads, "
    f"bool flip_filter) -> Tensor",
    cpu=lambda x, taps, up, down, pads, flip_filter: upfirdn2d_ref(
        x, taps, up, down, pads, flip_filter),
    # the plan's cache takes hashable arguments
    cuda=lambda x, taps, up, down, pads, flip_filter: _launch(
        x, tuple(taps), up, down, tuple(pads), flip_filter),
    fake=lambda x, taps, up, down, pads, flip_filter: _fake(
        x, taps, up, down, pads, flip_filter))


class _Upfirdn2d(torch.autograd.Function):
    """Forward: one launch of the kernel (the plain version for a CPU
    tensor).  Backward: the same Function as the transposed upfirdn."""

    @staticmethod
    def forward(ctx, x, taps, up, down, pads, flip_filter):
        ctx.args = (taps, up, down, pads, flip_filter)
        ctx.in_hw = (x.shape[1], x.shape[2])
        return op(x, taps, up, down, pads, flip_filter)

    @staticmethod
    def backward(ctx, g):
        taps, up, down, (px0, px1, py0, py1), flip_filter = ctx.args
        ih, iw = ctx.in_hw
        oh, ow = g.shape[1], g.shape[2]
        n = len(taps)
        pads = (n - px0 - 1, iw * up - ow * down + px0 - up + 1,
                n - py0 - 1, ih * up - oh * down + py0 - up + 1)
        gx = _Upfirdn2d.apply(g.contiguous(), taps, down, up, pads,
                              not flip_filter)
        return gx, None, None, None, None, None


def upfirdn2d_separable(x: torch.Tensor, taps: Sequence[float], up: int = 1,
                        down: int = 1, pads: Pads = (0, 0, 0, 0),
                        flip_filter: bool = False) -> torch.Tensor:
    """Separable upfirdn2d of NHWC ``x`` with the 1-D ``taps`` (already
    scaled by ``sqrt(gain)``) applied along H and W, ``pads = (px0, px1,
    py0, py1)``; differentiable in ``x`` to any order.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32/bfloat16, ``up`` and ``down`` in {1, 2}, 1 to 64 taps; made
    contiguous first)."""
    if x.ndim != 4:
        raise ValueError(f"{NAME}: x must be NHWC, got {tuple(x.shape)}")
    taps = tuple(float(t) for t in taps)
    pads = tuple(int(p) for p in pads)
    return _Upfirdn2d.apply(x.contiguous(), taps, int(up), int(down), pads,
                            bool(flip_filter))
