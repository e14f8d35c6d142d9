"""Kernel D's tile plan (``pgx_torch.ops.kernels.upfirdn2d._plan``): the
numbers the CUDA kernel is launched with, checked on the CPU.

For every distinct call of kernel D on the port's paths (the ADA gather
warp's upsample and downsample at 128, 256 and 512px and their backward
calls, recorded from the port's own ``upsample2d``/``downsample2d`` and
autograd on meta tensors; the ops layer's ``conv2d_resample`` block) and the
worst generic cases (64 taps, C = 64, up 1 / down 2 and up 2), in f32 and
bf16: the plan's shared memory fits a Hopper block, the tiles cover every
output pixel and channel exactly once, and the window the kernel derives for
a tile holds every input sample that the tile's outputs read.  At small
shapes, with negative and positive pads, every input index an output's taps
touch is enumerated in numpy and found inside its tile's window.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from pgx_torch.augment import pipe
from pgx_torch.ops import conv2d_resample, downsample2d, setup_filter, \
    upsample2d
from pgx_torch.ops.kernels import upfirdn2d as U

DTYPES = (torch.float32, torch.bfloat16)


def _record(run):
    """The (shape, ntaps, up, down, pads) of every kernel D call that
    ``run()`` makes on meta tensors, forward and backward: recorded in the
    op's fake implementation, which meta tensors reach in place of the
    launch."""
    calls = []

    def launch(x, taps, up, down, pads, flip_filter):
        calls.append((tuple(x.shape), len(taps), up, down, tuple(pads)))
        b, h, w, c = x.shape
        px0, px1, py0, py1 = pads
        return torch.empty(
            b, U.out_len(h, len(taps), up, down, py0, py1),
            U.out_len(w, len(taps), up, down, px0, px1), c, device="meta")

    with mock.patch.object(U, "_fake", launch):
        run()
    return calls


def _gather_calls(res):
    """The gather warp's two calls at ``res`` (batch 1), as
    ``augment_pipe`` makes them (pipe.py: reflect margin ``res - 1`` on
    each side, upsample2d, grid_sample to ``(res + 2*hz_pad) * 2``,
    downsample2d with ``padding=-2*hz_pad``), and their backward calls."""
    hz = pipe._hz_geom()
    hz_pad = hz.shape[0] // 4

    def run():
        x = torch.empty(1, 3 * res - 2, 3 * res - 2, 3, device="meta",
                        requires_grad=True)
        up = upsample2d(x, hz, up=2)
        side = (res + 2 * hz_pad) * 2
        y = torch.empty(1, side, side, 3, device="meta", requires_grad=True)
        down = downsample2d(y, hz, down=2, padding=-hz_pad * 2,
                            flip_filter=True)
        assert down.shape == (1, res, res, 3)
        torch.autograd.grad((up.sum(), down.sum()), (x, y))

    return _record(run)


def _ops_block_calls():
    """The ops layer's block of chip_smoke.py (conv2d_resample, up 2,
    [1,3,3,1] separable, padding 1) at batch 1."""
    f = setup_filter([1, 3, 3, 1], separable=True)

    def run():
        x = torch.empty(1, 64, 64, 64, device="meta")
        w = torch.empty(3, 3, 64, 256, device="meta")
        conv2d_resample(x, w, f, up=2, padding=1)

    return _record(run)


def _path_calls():
    calls = []
    for res in (128, 256, 512):
        calls += _gather_calls(res)
    calls += _ops_block_calls()
    calls += [((1, 200, 200, 64), 64, 1, 2, (31, 32, 31, 32)),
              ((1, 100, 100, 64), 64, 2, 1, (32, 31, 32, 31))]
    return sorted(set(calls))


PATH_CALLS = _path_calls()


def test_the_recorded_paths_are_the_expected_calls():
    # 2 forward + 2 backward calls at each of three resolutions, the ops
    # block, the two generic cases
    assert len(PATH_CALLS) == 15
    assert ((1, 382, 382, 3), 12, 2, 1, (6, 5, 6, 5)) in PATH_CALLS
    assert ((1, 268, 268, 3), 12, 1, 2, (-1, -1, -1, -1)) in PATH_CALLS
    assert ((1, 764, 764, 3), 12, 1, 2, (5, 5, 5, 5)) in PATH_CALLS
    assert ((1, 128, 128, 3), 12, 2, 1, (12, 11, 12, 11)) in PATH_CALLS
    assert ((1, 64, 64, 64), 4, 2, 1, (3, 2, 3, 2)) in PATH_CALLS


def _cover_once(n, tile, org, tiles):
    """Every index of [0, n) lies in exactly one of the tiles' ranges."""
    hits = np.zeros(n, np.int64)
    for t in range(tiles):
        lo, hi = t * tile + org, (t + 1) * tile + org
        hits[max(lo, 0):max(min(hi, n), 0)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("call", PATH_CALLS, ids=str)
def test_plan_fits_and_covers_each_output_once(call, dtype):
    shape, ntaps, up, down, pads = call
    b, h, w, c = shape
    for batch in (1, 32):
        p = U._plan((batch, h, w, c), ntaps, up, down, pads, dtype)
        assert p.smem_bytes <= U.SMEM_MAX == 232_448
        assert p.smem_bytes <= U.SMEM_TARGET
        assert p.tile_h % U.RUN == 0 and p.tile_w % U.RUN == 0
        assert p.vec * dtype.itemsize == 16
        assert p.oh == U.out_len(h, ntaps, up, down, pads[2], pads[3])
        assert p.ow == U.out_len(w, ntaps, up, down, pads[0], pads[1])
        assert _cover_once(p.oh, p.tile_h, p.org_y, p.tiles_y)
        assert _cover_once(p.ow, p.tile_w, p.org_x, p.tiles_x)
        assert _cover_once(c, p.tile_c, 0, p.chunks)
        assert p.tiles_y * p.tiles_x * p.chunks * batch <= 2 ** 31 - 1
        # the staged rows: whole units of x's rows, room for the offset
        if p.tile_c == c:
            assert (w * c) % p.stage_vec == 0
        assert 16 % (p.stage_vec * dtype.itemsize) == 0
        assert p.in_pitch % p.vec == 0
        assert p.in_pitch >= p.win_w * p.tile_c + 2 * p.vec - 2
        # the buffers, at their offsets
        wq = p.win_w * p.tile_c * dtype.itemsize
        assert p.off_mid >= p.win_h * p.in_pitch * dtype.itemsize
        assert p.off_out - p.off_mid >= p.tile_h * wq
        assert p.off_taps - p.off_out >= (p.tile_h * p.seg_n * p.seg_pitch
                                          * dtype.itemsize)
        assert p.smem_bytes >= p.off_taps + 4 * U.MAX_TAPS


def _touched(n_in, n_out, ntaps, up, down, pad0):
    """For each output index, the input indices its taps meet (numpy
    enumeration of ``out[j] = sum_t taps[t] * d[j*down + t - pad0]``)."""
    j = np.arange(n_out)[:, None]
    pos = j * down + np.arange(ntaps)[None, :] - pad0   # stuffed positions
    hit = (pos >= 0) & (pos % up == 0) & (pos // up < n_in)
    return [np.unique(pos[k][hit[k]] // up) for k in range(n_out)]


def _window_holds_every_tap(p, h, w, ntaps, up, down, pads):
    px0, _, py0, _ = pads
    rows = _touched(h, p.oh, ntaps, up, down, py0)
    cols = _touched(w, p.ow, ntaps, up, down, px0)
    for ty in range(p.tiles_y):
        for tx in range(p.tiles_x):
            out_r, out_c = U._tile(p, ty, tx)
            win_r, win_c = U._window(p, ty, tx)
            for j in out_r:
                if 0 <= j < p.oh and not all(r in win_r for r in rows[j]):
                    return False
            for i in out_c:
                if 0 <= i < p.ow and not all(s in win_c for s in cols[i]):
                    return False
    return True


SMALL = [((2, 16, 17, 3), 12, 1, 1, (0, 0, 0, 0)),
         ((2, 9, 11, 3), 12, 2, 1, (2, 1, 3, 0)),
         ((2, 30, 30, 3), 12, 2, 1, (6, 5, 6, 5)),
         ((2, 23, 21, 3), 12, 2, 1, (7, 4, 5, 6)),
         ((2, 40, 38, 3), 12, 1, 2, (-1, -1, -1, -1)),
         ((1, 41, 38, 3), 12, 1, 2, (-7, -3, -2, -9)),
         ((2, 20, 21, 3), 12, 2, 1, (12, 11, 12, 11)),
         ((2, 8, 8, 5), 12, 2, 2, (-1, 2, 0, -1)),
         ((1, 19, 17, 5), 7, 2, 2, (3, -2, -3, 4)),
         ((1, 9, 10, 64), 4, 2, 1, (3, 2, 3, 2)),
         ((1, 12, 10, 130), 4, 1, 2, (1, 1, 2, 1)),
         ((1, 5, 6, 1), 7, 2, 1, (3, 3, 2, 4)),
         ((1, 3, 2, 3), 12, 2, 1, (6, 5, 6, 5)),
         ((1, 40, 36, 2), 64, 1, 2, (31, 32, 30, 33)),
         ((1, 20, 19, 2), 64, 2, 1, (33, 30, 32, 31))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SMALL, ids=str)
def test_window_holds_every_input_the_tile_reads(case, dtype):
    shape, ntaps, up, down, pads = case
    _, h, w, c = shape
    for tile in (None, (8, 8, 1), (16, 8, min(c, 2))):
        p = (U._plan(shape, ntaps, up, down, pads, dtype) if tile is None
             else U._tile_plan(shape, ntaps, up, down, pads, dtype, tile))
        assert _window_holds_every_tap(p, h, w, ntaps, up, down, pads), tile
        assert _cover_once(p.oh, p.tile_h, p.org_y, p.tiles_y)
        assert _cover_once(p.ow, p.tile_w, p.org_x, p.tiles_x)


def test_window_check_catches_a_short_window():
    """The enumeration above fails a window one row short."""
    p = U._plan((1, 30, 30, 3), 12, 2, 1, (6, 5, 6, 5), torch.float32)
    short = U._PlanC.from_buffer_copy(p)
    short.win_h -= 1
    assert _window_holds_every_tap(p, 30, 30, 12, 2, 1, (6, 5, 6, 5))
    assert not _window_holds_every_tap(short, 30, 30, 12, 2, 1,
                                       (6, 5, 6, 5))


def test_up2_down1_tiles_start_on_a_sample():
    """With up 2, down 1 and an odd leading pad the tiles start one output
    early, so that tap 0 of every thread's first output meets a sample: the
    fixed-count instantiations assume phase 0."""
    for pad0 in range(-3, 14):
        p = U._plan((1, 20, 20, 3), 12, 2, 1, (pad0, 5, pad0, 5),
                    torch.bfloat16)
        assert p.org_y == p.org_x == -(pad0 % 2)
        for t in range(p.tiles_y):
            assert (U._tile(p, t, 0)[0][0] * p.down - p.pad_y) % p.up == 0


def test_tile_plan_rejects_tiles_the_kernel_does_not_take():
    for tile in ((12, 8, 3), (8, 4, 3), (8, 8, 0), (8, 8, 4)):
        with pytest.raises(ValueError, match="multiples"):
            U._tile_plan((1, 8, 8, 3), 12, 2, 1, (6, 5, 6, 5), torch.float32,
                         tile)


def test_launch_args_are_the_plan_with_its_taps():
    """What the library is launched with: ``_plan``'s fields, the taps in
    the first ``ntaps`` slots and zeros after them, made once per call."""
    args = ((32, 382, 382, 3), tuple(np.linspace(0.1, 1.2, 12)), 2, 1,
            (6, 5, 6, 5), torch.bfloat16)
    p = U._plan(*args[:1], 12, *args[2:])
    c = U._launch_args(*args)
    assert U._launch_args(*args) is c
    for name, _ in U._PlanC._fields_[:-1]:
        assert getattr(c, name) == getattr(p, name), name
    assert np.allclose(list(c.taps)[:12], args[1], atol=1e-7)
    assert list(c.taps)[12:] == [0.0] * (U.MAX_TAPS - 12)
