"""Kernel W (``pgx_torch.ops.kernels.warp_resample``): the shear warp's
resampling passes as bands, forward and transpose.

On the CPU (tiny images): the warp on unpadded images equals, bit for bit,
the composition the pipe ran before kernel W (``F.pad``, then passes 0-4 as
einsums over the tent and filter matrices with kernel F's plain version
between), which is what each op's plain route keeps; each transpose's plain
version is the adjoint of its forward (f64); the Functions differentiate to
second order (``gradcheck``/``gradgradcheck`` in f64); CPU calls launch
nothing.

The ``gpu`` cases hold the four kernels against the plain route on the card
at 16, 128 and 512 px (batch 2, the recipe's grids): f32 within 1e-5 of the
largest output (the same f32 products summed in another order), bf16 within
two bf16 steps of it (the plain route computed in f32 on the same bf16
values: the kernels round once, at the store).  The samples cover a flip,
90-degree turns (the transposed blit), a rotation, extreme scales (a patch
too large to stage, and a zoom) and a translation past the shear margin.
Also on the card: the adjoint identity, gradients and a second derivative
against autograd through the plain route, W2 on the y-shear's strided crop,
the launch counts of one warp, and that no matrix is built for a CUDA
tensor.  They skip without a card:
``python -m pytest -m gpu tests/test_torch_warp_resample.py``.
"""

import importlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pgx_torch.ops import warp
from pgx_torch.ops.kernels import build, shift_1d_ref

# the package exports functions of the module's name: take the module
W = importlib.import_module("pgx_torch.ops.kernels.warp_resample")

SYM6 = np.asarray([0.015404109327027373, 0.0034907120842174702,
                   -0.11799011114819057, -0.048311742585633,
                   0.4910559419267466, 0.787641141030194, 0.3379294217276218,
                   -0.07263752278646252, -0.021060292512300564,
                   0.04472490177066578, 0.0017677118642428036,
                   -0.007800708325034148])
HZ = tuple(float(v) for v in (SYM6 / SYM6.sum()).astype(np.float32))


def _affines(kind: str, b: int, seed: int, res: int = 16):
    """``(a_mat [b, 2, 2], t_vec [b, 2])`` f32 of one kind of sample on a
    ``res``-pixel image."""
    rng = np.random.RandomState(seed)
    eye = np.tile(np.eye(2), (b, 1, 1))
    t = rng.randn(b, 2) * 2.0
    if kind == "flip":                   # x and y flips, no rotation
        a = eye * np.where(rng.rand(b, 1, 2) < 0.5, -1.0, 1.0)
    elif kind == "turn90":               # the transposed blit
        a = np.stack([np.array([[0.0, -1.0], [1.0, 0.0]]),
                      np.array([[0.0, 1.0], [-1.0, 0.0]])] * b)[:b]
    elif kind == "rotate":
        th = rng.uniform(-np.pi, np.pi, b)
        a = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                      np.stack([np.sin(th), np.cos(th)], -1)], 1)
    elif kind == "scale":                # a patch too large, and a zoom
        a = eye * np.array([[3.1, 1.0], [1.0, 0.3]])[None]
        a[1:] = eye[1:] * np.array([[0.25, 1.0], [1.0, 2.6]])[None]
    elif kind == "translate":            # past the shear margin
        a = eye
        t = np.array([[1.3, -0.2], [-0.4, 2.2]])[:b] * res
    else:
        raise ValueError(kind)
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(t.astype(np.float32)))


def _params(kind: str, b: int, seed: int, dev="cpu", res: int = 16):
    a, t = _affines(kind, b, seed, res)
    params, alpha, gamma = warp.resample_params(a, t)
    return params.to(dev), alpha.to(dev), gamma.to(dev)


def _padded_composition(images, a, t, hz, margin=1.0):
    """The warp as the pipe ran it before kernel W: ``F.pad``, then passes
    0-4 on the padded batch as einsums, kernel F's plain version between."""
    b, h, w, c = images.shape
    dev = images.device
    padded = F.pad(images.permute(0, 3, 1, 2), (w - 1, w - 1, h - 1, h - 1),
                   mode="reflect").permute(0, 2, 3, 1)
    hp, wp = padded.shape[1:3]
    out_n, vy, vx, my2, mx2 = warp.warp_extents(h, len(hz), margin)
    u2 = torch.from_numpy(W._static_matrices(wp, w, hz)[0])
    d2 = torch.from_numpy(W._static_matrices(hp, h, hz)[1])
    swap, sx, sy, alpha, gamma, aa, bb, cc, dd, tx, ty = warp._decompose(
        a, t)
    padded = torch.where(swap[:, None, None, None], padded.transpose(1, 2),
                         padded)
    t_x = 0.5 * (aa + bb) + 2.0 * tx - 0.5
    t_y = 0.5 * (cc + dd) + 2.0 * ty - 0.5
    ux = sx[:, None] * W._centered(vx, dev)[None, :] + t_x[:, None]
    uy = sy[:, None] * W._centered(vy, dev)[None, :] + t_y[:, None]
    mx_mat = torch.einsum("bmk,kw->bmw", W._tent_matrix(ux, 2 * wp), u2)
    my_mat = torch.einsum("bmk,kh->bmh", W._tent_matrix(uy, 2 * hp), u2)
    dt = padded.dtype
    v = torch.einsum("bmw,bhwc->bhmc", mx_mat.to(dt), padded)
    v = torch.einsum("bnh,bhmc->bcnm", my_mat.to(dt), v)
    v = shift_1d_ref(v, alpha[:, None] * W._centered(vy)[None, :], 3)
    v = v[:, :, :, mx2:mx2 + out_n]
    v = shift_1d_ref(v, gamma[:, None] * W._centered(out_n)[None, :], 2)
    v = v[:, :, my2:my2 + out_n, :]
    d2 = d2.to(dt)
    v = torch.einsum("hm,bcmw->bchw", d2, v)
    return torch.einsum("wn,bchn->bhwc", d2, v)


# ---------------------------------------------------------------------------
# CPU: the plain route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,c,kind", [(8, 3, "rotate"), (16, 1, "turn90"),
                                        (16, 3, "scale")])
def test_warp_equals_the_padded_composition(res, c, kind):
    images = torch.from_numpy(np.tanh(
        np.random.RandomState(res).randn(2, res, res, c)).astype(np.float32))
    a, t = _affines(kind, 2, seed=res)
    got = warp.ada_geom_warp_shear(images, a, t, HZ)
    want = _padded_composition(images, a, t, HZ)
    assert got.shape == images.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,kind", [(3, "rotate"), (1, "turn90")])
def test_plain_transposes_are_adjoints(c, kind):
    n = 6
    rng = np.random.RandomState(c)
    params, _, _ = _params(kind, 2, seed=c)
    _, vy, vx, _, _ = warp.warp_extents(n, len(HZ))
    x = torch.from_numpy(rng.randn(2, n, n, c))
    y = torch.from_numpy(rng.randn(2, c, vy, vx))
    lhs = (W.warp_resample_ref(x, params, vy, vx, HZ) * y).sum()
    rhs = (x * W.warp_resample_t_ref(y, params, n, HZ)).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs).clamp_min(1)
    r = 2 * n + 12
    v = torch.from_numpy(rng.randn(2, c, r, r))
    g = torch.from_numpy(rng.randn(2, n, n, c))
    lhs = (W.warp_down2_ref(v, HZ) * g).sum()
    rhs = (v * W.warp_down2_t_ref(g, HZ)).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs).clamp_min(1)


def test_functions_differentiate_twice():
    n = 4
    rng = np.random.RandomState(5)
    params, _, _ = _params("rotate", 1, seed=5)
    _, vy, vx, _, _ = warp.warp_extents(n, len(HZ))
    x = torch.from_numpy(rng.randn(1, n, n, 1)).requires_grad_(True)
    v = torch.from_numpy(rng.randn(1, 1, 2 * n + 12, 2 * n + 12)
                         ).requires_grad_(True)
    for fn, arg in ((lambda x: W.warp_resample(x, params, vy, vx, HZ), x),
                    (lambda v: W.warp_down2(v, HZ), v)):
        assert torch.autograd.gradcheck(fn, (arg,), fast_mode=True)
        assert torch.autograd.gradgradcheck(fn, (arg,), fast_mode=True)


def test_cpu_calls_launch_nothing_and_bad_inputs_raise():
    params, _, _ = _params("flip", 1, seed=0)
    x = torch.randn(1, 5, 5, 3, requires_grad=True)
    before = build.launch_counts()
    out = W.warp_resample(x, params, 64, 128, HZ)
    out.sum().backward()
    W.warp_down2(torch.randn(1, 3, 22, 22, requires_grad=True),
                 HZ).sum().backward()
    assert build.launch_counts() == before
    with pytest.raises(ValueError, match="square"):
        W.warp_resample(torch.zeros(1, 5, 6, 3), params, 64, 128, HZ)
    with pytest.raises(ValueError, match="taps"):
        W.warp_resample(x, params, 64, 128, HZ[:8])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

KINDS = ["flip", "turn90", "rotate", "scale", "translate"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, want):
    scale = want.abs().max().item()
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2.0 * 2.0 ** (math.floor(math.log2(max(scale, 1e-3))) - 7)


def _held(got, want, dtype):
    """got (the kernel, in dtype) against want (the plain route in f32)."""
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    assert err <= _tol(dtype, want), (err, want.abs().max().item())


def _rand(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [16, 128, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_resample_and_transpose_match_plain(cuda, dtype, res, kind):
    params, _, _ = _params(kind, 2, seed=res, dev=cuda, res=res)
    _, vy, vx, _, _ = warp.warp_extents(res, len(HZ))
    x = _rand((2, res, res, 3), 1, cuda, dtype)
    g = _rand((2, 3, vy, vx), 2, cuda, dtype)
    before = build.launch_counts()
    with torch.no_grad():
        got = W.warp_resample(x, params, vy, vx, HZ)
        got_t = W.transpose_op(g, params, res, HZ)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[W.NAME] == before[W.NAME] + 1
    assert after[W.NAME_T] == before[W.NAME_T] + 1
    with torch.no_grad():
        want = W.warp_resample_ref(x.float(), params, vy, vx, HZ)
        want_t = W.warp_resample_t_ref(g.float(), params, res, HZ)
    _held(got, want, dtype)
    _held(got_t, want_t, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [16, 128, 512])
def test_gpu_down2_and_transpose_match_plain(cuda, dtype, res):
    r = 2 * res + 12
    v = _rand((2, 3, r, r), 3, cuda, dtype)
    g = _rand((2, res, res, 3), 4, cuda, dtype)
    before = build.launch_counts()
    with torch.no_grad():
        got = W.warp_down2(v, HZ)
        got_t = W.down_transpose_op(g, HZ)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after[W.NAME_DOWN] == before[W.NAME_DOWN] + 1
    assert after[W.NAME_DOWN_T] == before[W.NAME_DOWN_T] + 1
    _held(got, W.warp_down2_ref(v.float(), HZ), dtype)
    _held(got_t, W.warp_down2_t_ref(g.float(), HZ), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rotate", "scale"])
def test_gpu_adjoint_identity(cuda, kind):
    res = 128
    params, _, _ = _params(kind, 2, seed=7, dev=cuda)
    _, vy, vx, _, _ = warp.warp_extents(res, len(HZ))
    x = _rand((2, res, res, 3), 5, cuda)
    y = _rand((2, 3, vy, vx), 6, cuda)
    with torch.no_grad():
        lhs = (W.warp_resample(x, params, vy, vx, HZ).double()
               * y.double()).sum().item()
        rhs = (x.double() * W.transpose_op(y, params, res, HZ).double()
               ).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    r = 2 * res + 12
    v = _rand((2, 3, r, r), 7, cuda)
    g = _rand((2, res, res, 3), 8, cuda)
    with torch.no_grad():
        lhs = (W.warp_down2(v, HZ).double() * g.double()).sum().item()
        rhs = (v.double() * W.down_transpose_op(g, HZ).double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.gpu
def test_gpu_gradients_and_second_derivative_match_plain(cuda):
    """First order through the warp (kernels W and F) against autograd
    through the plain route; second order: the derivative of the input
    gradient with respect to the output gradient is W applied again."""
    res = 128
    a, t = _affines("rotate", 2, seed=9)
    a, t = a.to(cuda), t.to(cuda)
    x = _rand((2, res, res, 3), 9, cuda)
    g = _rand((2, res, res, 3), 10, cuda)
    u = _rand((2, res, res, 3), 11, cuda)

    def grads(route):
        leaf = x.clone().requires_grad_(True)
        gg = g.clone().requires_grad_(True)
        out = warp.ada_geom_warp_shear(leaf, a, t, HZ)
        gx, = torch.autograd.grad((out * gg).sum(), leaf, create_graph=True)
        ggg, = torch.autograd.grad((gx * u).sum(), gg)
        return out.detach(), gx.detach(), ggg

    before = build.launch_counts()
    got = grads("kernel")
    after = build.launch_counts()
    # forward, the backward, and the backward's own derivative
    assert after[W.NAME] - before[W.NAME] == 2
    assert after[W.NAME_T] - before[W.NAME_T] == 1
    assert after[W.NAME_DOWN] - before[W.NAME_DOWN] == 2
    assert after[W.NAME_DOWN_T] - before[W.NAME_DOWN_T] == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(warp, "warp_resample", lambda img, p, vy, vx, taps:
                   W.warp_resample_ref(img, p, vy, vx, taps))
        mp.setattr(warp, "warp_down2", W.warp_down2_ref)
        mp.setattr(warp, "shift_1d", shift_1d_ref)
        want = grads("plain")
    torch.cuda.synchronize()
    for k, w in zip(got, want):
        assert (k - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_down2_reads_the_strided_crop(cuda, dtype):
    """W2 on the y-shear's row crop, as the warp hands it over (a view
    into [B, C, Vy, out_n]), and at an odd bf16 offset (copied)."""
    res = 128
    out_n, vy, _, my2, _ = warp.warp_extents(res, len(HZ))
    big = _rand((2, 3, vy, out_n), 12, cuda, dtype)
    view = big[:, :, my2:my2 + out_n, :]
    assert not view.is_contiguous()
    with torch.no_grad():
        got = W.warp_down2(view, HZ)
        want = W.warp_down2(view.contiguous(), HZ)
    assert torch.equal(got, want)
    if dtype == torch.bfloat16:
        flat = _rand((2 * 3 * out_n * out_n + 1,), 13, cuda, dtype)
        odd = flat[1:].view(2, 3, out_n, out_n)
        assert odd.data_ptr() % 4
        with torch.no_grad():
            _held(W.warp_down2(odd, HZ),
                  W.warp_down2_ref(odd.float(), HZ), dtype)


@pytest.mark.gpu
def test_gpu_warp_builds_no_matrix_and_counts_its_launches(cuda):
    """A CUDA warp never takes the einsum route: with the functions that
    build the matrices made to raise it still runs, forward and backward,
    launching W1, W2, their transposes once each and F four times."""
    res = 64
    a, t = _affines("rotate", 2, seed=14)
    x = _rand((2, res, res, 3), 14, cuda, torch.bfloat16).requires_grad_(True)

    def refuse(*args, **kw):
        raise AssertionError("a matrix was built for a CUDA tensor")

    before = build.launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_band_matrices", "_down_matrices", "_static_matrices",
                     "_tent_matrix"):
            mp.setattr(W, name, refuse)
        out = warp.ada_geom_warp_shear(x, a.to(cuda), t.to(cuda), HZ)
        out.float().sum().backward()
    torch.cuda.synchronize()
    after = build.launch_counts()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert got == {W.NAME: 1, W.NAME_T: 1, W.NAME_DOWN: 1, W.NAME_DOWN_T: 1,
                   "shift_1d": 4}
    assert torch.isfinite(x.grad.float()).all()


@pytest.mark.gpu
def test_gpu_rejects_what_the_kernels_do_not_take(cuda):
    params, _, _ = _params("flip", 1, seed=0, dev=cuda)
    with pytest.raises(ValueError, match="channels"):
        W.warp_resample(torch.zeros(1, 8, 8, 4, device=cuda), params, 128,
                        256, HZ)
    with pytest.raises(TypeError, match="dtype"):
        W.warp_resample(torch.zeros(1, 8, 8, 3, device=cuda,
                                    dtype=torch.float64), params, 128, 256,
                        HZ)
    with pytest.raises(ValueError, match="channels"):
        W.warp_down2(torch.zeros(1, 4, 28, 28, device=cuda), HZ)
