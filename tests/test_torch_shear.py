"""pgx_torch's kernel F wrapper and shear warp against pgx on the CPU.

On the CPU ``shift_1d`` takes its plain version, which is held against
pgx's contract ``_shift_1d_jnp`` and against pgx's Pallas kernel
``shift_1d_pallas`` in interpret mode on the same numpy inputs (f32).
Tolerance 1e-6 absolute on O(1) data: the same two-tap blend in f32, where
XLA may contract the multiply-add.  The backward (the Function with the
shift negated) is held against ``jax.vjp`` of the contract.

``ada_geom_warp_shear`` (unpadded images; its pass 0 pads them) is held
against pgx's on the same images reflect-padded by ``jnp.pad``, in f64
images with the f32 matrices both packages build: 1e-5 absolute (the tent
matrices are f32 products summed in another order; a shift whose floor
differs by one f32 bit would show as a whole-pixel error, far above this).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.ops import warp as jwarp
from pgx.ops.pallas.shear import shift_1d_pallas
from pgx_torch.ops import warp as twarp
# the package exports a function of the module's name: take the module
twres = importlib.import_module("pgx_torch.ops.kernels.warp_resample")
from pgx_torch.ops.kernels import shear as tshear
from pgx_torch.ops.kernels import launch_counts, shift_1d, shift_1d_ref

ATOL = 1e-6


def _case(shape, axis, scale, seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(*shape).astype(np.float32)
    lines = shape[2] if axis == 3 else shape[3]
    shift = (rng.randn(shape[0], lines) * scale).astype(np.float32)
    return img, shift


CASES = [
    # shape [B, C, R, N], axis, shift scale
    ((2, 3, 64, 128), 3, 40.0),
    ((2, 3, 64, 128), 2, 40.0),
    ((2, 3, 52, 128), 3, 30.0),       # R not a multiple of 8
    ((1, 2, 64, 100), 2, 20.0),       # N not a multiple of 4 or 8
    ((1, 1, 272, 131), 2, 40.0),      # the 256px extent class, odd N
    ((2, 2, 16, 24), 3, 60.0),        # shifts far beyond +-L
    ((2, 2, 16, 24), 2, 60.0),
    ((1, 3, 7, 5), 3, 0.0),           # zero shift: the identity
]


@pytest.mark.parametrize("shape,axis,scale", CASES)
def test_shift_1d_matches_pgx_contract(shape, axis, scale):
    img, shift = _case(shape, axis, scale, seed=axis * 10 + shape[2])
    want = np.asarray(jwarp._shift_1d_jnp(jnp.asarray(img),
                                          jnp.asarray(shift), axis))
    got = shift_1d(torch.from_numpy(img), torch.from_numpy(shift), axis)
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if scale == 0.0:
        np.testing.assert_array_equal(got.numpy(), img)


@pytest.mark.parametrize("shape,axis,scale", CASES[:6])
def test_shift_1d_matches_pallas_interpret(shape, axis, scale):
    img, shift = _case(shape, axis, scale, seed=axis * 10 + shape[2] + 1)
    want = np.asarray(shift_1d_pallas(jnp.asarray(img), jnp.asarray(shift),
                                      axis, interpret=True))
    got = shift_1d(torch.from_numpy(img), torch.from_numpy(shift), axis)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_shift_1d_extreme_shifts_read_zeros():
    """|shift| >= L + 1 leaves nothing of the line; the clip at +-(L+2)
    keeps the integer part representable."""
    img = torch.ones(1, 1, 4, 8)
    for axis, lines in ((3, 4), (2, 8)):
        for s in (1e9, -1e9, 9.0, -9.5):
            out = shift_1d(img, torch.full((1, lines), s), axis)
            if abs(s) >= img.shape[axis] + 1:
                assert float(out.abs().max()) == 0.0, (axis, s)
    out = shift_1d(img, torch.full((1, 4), 7.5), 3)       # half of one tap
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               [0.5, 0, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("axis", [2, 3])
def test_shift_1d_backward_matches_jax_vjp(axis):
    img, shift = _case((2, 2, 32, 48), axis, 20.0, seed=3)
    ct = np.random.RandomState(4).randn(*img.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jwarp._shift_1d_jnp(x, jnp.asarray(shift),
                                                   axis), jnp.asarray(img))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    x = torch.from_numpy(img).requires_grad_(True)
    s = torch.from_numpy(shift).requires_grad_(True)
    out = shift_1d(x, s, axis)
    got, = torch.autograd.grad(out, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the backward is the shift by -s ...
    np.testing.assert_allclose(
        got.numpy(), shift_1d_ref(torch.from_numpy(ct),
                                  -torch.from_numpy(shift), axis).numpy(),
        atol=0, rtol=0)
    # ... the shift gets no gradient, and autograd through the plain
    # version agrees
    assert not out.grad_fn.next_functions[1][0]
    x2 = torch.from_numpy(img).requires_grad_(True)
    ref, = torch.autograd.grad(shift_1d_ref(x2, torch.from_numpy(shift),
                                            axis), x2, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_shift_1d_differentiates_twice_and_in_f64():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 2, 5, 6)).requires_grad_(True)
    s = torch.from_numpy(rng.randn(1, 5) * 3)
    assert shift_1d(x, s, 3).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda v: shift_1d(v, s, 3), (x,))
    assert torch.autograd.gradgradcheck(lambda v: shift_1d(v, s, 3), (x,))
    s2 = torch.from_numpy(rng.randn(1, 6) * 3)
    assert torch.autograd.gradcheck(lambda v: shift_1d(v, s2, 2), (x,))


def test_shift_1d_bf16_blends_in_f32():
    """bf16 in and out with one rounding: the plain version equals the f32
    result rounded to bf16."""
    img, shift = _case((1, 2, 8, 16), 3, 4.0, seed=6)
    xb = torch.from_numpy(img).to(torch.bfloat16)
    got = shift_1d(xb, torch.from_numpy(shift), 3)
    want = shift_1d(xb.float(), torch.from_numpy(shift), 3).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_shift_1d_checks_and_counts():
    before = launch_counts()
    x = torch.zeros(2, 1, 4, 6)
    with pytest.raises(ValueError, match="axis"):
        shift_1d(x, torch.zeros(2, 4), 1)
    with pytest.raises(ValueError, match="shift shape"):
        shift_1d(x, torch.zeros(2, 6), 3)
    with pytest.raises(ValueError, match="B, C, R, N"):
        shift_1d(x[0], torch.zeros(2, 4), 3)
    shift_1d(x, torch.zeros(2, 4), 3)
    assert launch_counts() == before        # CPU calls launch nothing
    assert tshear.NAME in before


@pytest.mark.parametrize("axis", [2, 3])
def test_shift_1d_reads_a_strided_view(axis):
    """The warp's column crop ``v[..., m:m + n]``: the kernel reads it in
    place (strided rows), the plain version through the view; both match
    pgx's contract on the cropped array, and the gradient lands on the
    whole tensor's window."""
    rng = np.random.RandomState(7 + axis)
    big = rng.randn(2, 3, 40, 96).astype(np.float32)
    view = torch.from_numpy(big).requires_grad_(True)[..., 17:17 + 42]
    assert not view.is_contiguous() and view.stride(-1) == 1
    lines = 40 if axis == 3 else 42
    shift = (rng.randn(2, lines) * 9).astype(np.float32)
    want = np.asarray(jwarp._shift_1d_jnp(
        jnp.asarray(big[..., 17:17 + 42]), jnp.asarray(shift), axis))
    got = shift_1d(view, torch.from_numpy(shift), axis)
    assert got.is_contiguous() and got.shape == view.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    ct = rng.randn(*got.shape).astype(np.float32)
    g, = torch.autograd.grad(got, view, torch.from_numpy(ct))
    np.testing.assert_allclose(
        g.numpy(), shift_1d_ref(torch.from_numpy(ct),
                                -torch.from_numpy(shift), axis).numpy(),
        atol=0, rtol=0)


def test_unit_is_the_widest_that_divides_pointer_strides_and_row():
    # the 128px warp, bf16: the y-shear's input is columns 314 .. 582 of a
    # [32, 3, 576, 896] tensor, its output a contiguous [32, 3, 576, 268]
    x = torch.zeros(2, 3, 576, 896, dtype=torch.bfloat16)
    view = x[..., 314:314 + 268]
    assert tshear._unit(view.data_ptr(), view.stride()[:3], 268, 2) == 4
    assert tshear._unit(x.data_ptr(), x.stride()[:3], 896, 2) == 16
    assert tshear._unit(0, (), 268, 2) == 8        # 536-byte output rows
    assert tshear._unit(0, (), 268, 4) == 16
    assert tshear._unit(0, (), 101, 2) == 2
    assert tshear._unit(0, (), 5, 4) == 4          # never below an element
    assert tshear._unit(2, (896,), 268, 2) == 2    # a 2-byte start


def _staged_rows_emulation(img, shift):
    """csrc/shear.cu's axis-2 kernel in numpy, f64, for one [R, N] plane:
    per tile of TILE_ROWS x STRIP outputs, the strip's k range, the band of
    input rows [r0 + kmin, r0 + rows + kmax] with zero rows outside
    [0, R), and each output's two taps read from the band (device memory
    where the band would exceed BAND_ROWS).  Returns the output and the
    number of tiles that read device memory."""
    r_ext, n_ext = img.shape
    out = np.zeros_like(img)
    direct = 0
    for r0 in range(0, r_ext, tshear.TILE_ROWS):
        for n0 in range(0, n_ext, tshear.STRIP):
            rows = min(tshear.TILE_ROWS, r_ext - r0)
            cols = np.arange(n0, min(n0 + tshear.STRIP, n_ext))
            sv = np.clip(shift[cols].astype(np.float32), -(r_ext + 2.0),
                         r_ext + 2.0)
            fl = np.floor(sv)                  # f32, as the kernel takes it
            k, f = fl.astype(np.int64), (sv - fl).astype(np.float64)
            kmin, need = k.min(), rows + k.max() - k.min() + 1
            rr = np.arange(rows)[:, None]
            if need <= tshear.BAND_ROWS:
                src = r0 + kmin + np.arange(need)
                ok = (src >= 0) & (src < r_ext)
                band = np.zeros((need, len(cols)))
                band[ok] = img[src[ok]][:, cols]
                at = rr + k[None, :] - kmin
                idx = np.arange(len(cols))[None, :]
                a0, a1 = band[at, idx], band[at + 1, idx]
            else:
                direct += 1
                p = r0 + rr + k[None, :]

                def tap(q):
                    inside = (q >= 0) & (q < r_ext)
                    return np.where(inside, img[np.clip(q, 0, r_ext - 1),
                                                cols[None, :]], 0.0)
                a0, a1 = tap(p), tap(p + 1)
            out[r0:r0 + rows, cols] = (1.0 - f) * a0 + f * a1
    return out, direct


@pytest.mark.parametrize("r_ext,n_ext", [(576, 268), (1088, 524),
                                         (2112, 1036)])
def test_staged_band_holds_every_tap_of_the_warp(r_ext, n_ext):
    """The y-shear's extents at 128, 256 and 512px, with the warp's shifts
    ``gamma * centred column`` for |gamma| up to 2 (pure rotations reach
    1): every tile is staged, every tap an output reads lies in its band,
    and the result is the plain version's."""
    rng = np.random.RandomState(r_ext)
    img = rng.randn(r_ext, n_ext)
    centred = np.arange(n_ext) - (n_ext / 2 - 0.5)
    for gamma in (-2.0, -1.0, -0.37, 0.0, 0.61, 1.0, 2.0):
        shift = gamma * centred + rng.uniform(-3, 3)
        got, direct = _staged_rows_emulation(img, shift)
        assert direct == 0, gamma
        want = shift_1d_ref(torch.from_numpy(img)[None, None],
                            torch.from_numpy(shift.astype(np.float32))[None],
                            2)[0, 0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_tiles_with_spread_shifts_read_device_memory():
    """Shifts that are no shear (random per column) leave the band; those
    tiles read their taps directly, with the same result."""
    rng = np.random.RandomState(3)
    img = rng.randn(150, 70)
    shift = rng.randn(70) * 60
    got, direct = _staged_rows_emulation(img, shift)
    assert direct > 0
    want = shift_1d_ref(torch.from_numpy(img)[None, None],
                        torch.from_numpy(shift.astype(np.float32))[None],
                        2)[0, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# the warp built on it
# ---------------------------------------------------------------------------

def test_static_helpers_match_pgx():
    f = np.random.RandomState(0).randn(12)
    for kw in (dict(up=2, down=1, pad0=6, pad1=5, flip_filter=False),
               dict(up=1, down=2, pad0=-1, pad1=-1, flip_filter=True),
               dict(up=2, down=2, pad0=4, pad1=4, flip_filter=True)):
        np.testing.assert_array_equal(
            twres.upfirdn_matrix_1d(37, f, **kw),
            jwarp.upfirdn_matrix_1d(37, f, **kw))
    hz = tuple(np.linspace(0.1, 1.2, 12).tolist())
    for got, want in zip(twres._static_matrices(46, 16, hz),
                         jwarp._static_matrices(46, 16, hz)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twres._centered(7).numpy(),
                                  np.asarray(jwarp._centered(7)))
    u = np.random.RandomState(1).randn(2, 5).astype(np.float32) * 3
    np.testing.assert_allclose(
        twres._tent_matrix(torch.from_numpy(u), 8).numpy(),
        np.asarray(jwarp._tent_matrix(jnp.asarray(u), 8)), atol=1e-7)


def _affine(b, seed, rotate=True):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-np.pi, np.pi, b) if rotate else np.zeros(b)
    sc = np.exp2(rng.randn(b, 2) * 0.2)
    a = np.stack([np.stack([np.cos(th) * sc[:, 0], -np.sin(th) * sc[:, 1]],
                           -1),
                  np.stack([np.sin(th) * sc[:, 0], np.cos(th) * sc[:, 1]],
                           -1)], 1)
    t = rng.randn(b, 2) * 2.0
    return a.astype(np.float32), t.astype(np.float32)


def test_decompose_matches_pgx():
    a, t = _affine(16, seed=2)
    a[0] = [[0.0, 1.0], [-1.0, 0.0]]          # a 90-degree turn: the pivot
    a[1] = [[1e-12, 0.5], [0.5, 0.0]]         # safe() on a vanishing entry
    got = twarp._decompose(torch.from_numpy(a), torch.from_numpy(t))
    want = jwarp._decompose(jnp.asarray(a), jnp.asarray(t))
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("res,c", [(16, 3), (8, 1)])
def test_ada_geom_warp_shear_matches_pgx(res, c, rotate):
    rng = np.random.RandomState(res + c)
    hz = np.linspace(0.2, 1.0, 12)
    hz = (hz / hz.sum()).astype(np.float32)
    b, pad = 3, res - 1
    images = np.tanh(rng.randn(b, res, res, c))
    a, t = _affine(b, seed=res, rotate=rotate)

    def j_warp(v):              # pgx's warp takes the reflect-padded batch
        padded = jnp.pad(v, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                         mode="reflect")
        return jwarp.ada_geom_warp_shear(padded, jnp.asarray(a),
                                         jnp.asarray(t), (res, res), hz)

    want = np.asarray(j_warp(jnp.asarray(images)))
    x = torch.from_numpy(images).requires_grad_(True)
    got = twarp.ada_geom_warp_shear(x, torch.from_numpy(a),
                                    torch.from_numpy(t), hz)
    assert got.shape == (b, res, res, c) and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)

    ct = rng.randn(*want.shape)
    _, vjp = jax.vjp(j_warp, jnp.asarray(images))
    gx, = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=1e-5, rtol=0)


def test_warp_refuses_non_square():
    with pytest.raises(ValueError, match="square"):
        twarp.ada_geom_warp_shear(torch.zeros(1, 4, 5, 3),
                                  torch.eye(2)[None], torch.zeros(1, 2),
                                  np.ones(12) / 12)
