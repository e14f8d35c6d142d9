"""pgx_torch's kernels A/B/C against pgx's Pallas kernels, and the card
cases of all six kernels (F, D and E are held against pgx on the CPU in
tests/test_torch_shear.py and tests/test_torch_ops.py).

On the CPU the wrappers take their plain PyTorch versions, which are held
against pgx's Pallas kernels run in interpret mode (as pgx's own tests run
them) on the same numpy inputs, in f32.  Tolerance: atol/rtol 1e-5 — the
same f32 arithmetic summed in another order.  Where pgx's conv kernel gates
a shape out (W below its sublane tile, e.g. the 4x4 stage) the plain version
is held against pgx's XLA reference ``conv3x3_epilogue_ref`` instead.

Gradients: each wrapper is a ``torch.autograd.Function`` whose backward is
written by hand; on the CPU its forward takes the plain version, so the
same backward the card uses is held against ``jax.grad`` of the pgx
function (f32, atol/rtol 1e-5 of order-1 gradients), kernel A also to
second order against ``jax.grad`` of a gradient-penalty-shaped function of
``jax.grad``, and against finite differences in f64
(``gradcheck``/``gradgradcheck``).

The ``gpu`` cases hold each CUDA kernel against its plain version on the
card; they skip without one.  JAX is imported inside the fixtures, so the
file also runs where only torch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from pgx_torch.ops import kernels as K

ATOL = RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """pgx's Pallas modules with every pallas_call in interpreter mode
    (the pattern of tests/test_pallas_kernels.py)."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    from pgx.ops.pallas import conv_epilogue, epilogue, kernels
    for mod in (conv_epilogue, epilogue, kernels):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    return {"epilogue": epilogue, "kernels": kernels,
            "conv_epilogue": conv_epilogue}


@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (2, 8, 8, 256),
                                   (1, 4, 4, 512)])
def test_bias_pixelnorm_lrelu_matches_pallas(pallas_interpret, shape):
    import jax.numpy as jnp
    E = pallas_interpret["epilogue"]
    y, b = _rand(shape, 1), _rand(shape[-1:], 2)
    assert E.supported(jnp.asarray(y))
    want = np.asarray(E.bias_pixelnorm_lrelu(jnp.asarray(y), jnp.asarray(b),
                                             0.2))
    got = K.bias_pixelnorm_lrelu(torch.from_numpy(y), torch.from_numpy(b),
                                 0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,slope", [((2, 4, 4, 128), 0.2),
                                         ((3, 4, 4, 256), 0.1),
                                         ((2, 8, 8, 128), 0.2)])
def test_pixel_norm_lrelu_matches_pallas(pallas_interpret, shape, slope):
    import jax.numpy as jnp
    Kp = pallas_interpret["kernels"]
    x = _rand(shape, 3)
    want = np.asarray(Kp.pixel_norm_lrelu_pallas(jnp.asarray(x), slope))
    got = K.pixel_norm_lrelu(torch.from_numpy(x), slope)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout,pn", [
    ((2, 8, 8, 128), 128, True),
    ((1, 8, 8, 128), 256, True),
    ((2, 8, 16, 256), 128, False),
])
def test_conv3x3_epilogue_matches_pallas(pallas_interpret, shape, cout, pn):
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    x = _rand(shape, 4)
    w = _rand((3, 3, shape[-1], cout), 5, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 6, 0.1)
    assert C.supported(jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(C.conv3x3_epilogue_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), use_pixel_norm=pn,
        interpret=True))
    got = K.conv3x3_epilogue(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), use_pixel_norm=pn)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout,pn", [
    ((2, 4, 4, 128), 128, True),      # the 4x4 stage: below pgx's W gate
    ((2, 4, 4, 256), 128, False),
    ((1, 5, 3, 24), 40, True),        # C a multiple of 8, not of 128
])
def test_conv3x3_epilogue_matches_xla_ref(pallas_interpret, shape, cout, pn):
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    x = _rand(shape, 7)
    w = _rand((3, 3, shape[-1], cout), 8, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 9, 0.1)
    want = np.asarray(C.conv3x3_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), use_pixel_norm=pn))
    got = K.conv3x3_epilogue(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), use_pixel_norm=pn)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_autograd():
    """What is still refused: kernel C differentiates once only, so a
    double backward through it raises rather than return a wrong second
    derivative.  A and B record a graph; under ``no_grad`` none does."""
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    w = torch.randn(3, 3, 8, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y = K.conv3x3_epilogue(x, w, b)
    with pytest.raises(RuntimeError, match="differentiable once only"):
        torch.autograd.grad(y.sum(), x, create_graph=True)
    gx, = torch.autograd.grad(y.sum(), x)          # first order is fine
    assert gx.shape == x.shape and not gx.requires_grad
    assert K.pixel_norm_lrelu(x).requires_grad
    assert K.bias_pixelnorm_lrelu(x, b).requires_grad
    with torch.no_grad():
        assert not K.pixel_norm_lrelu(x).requires_grad
        assert not K.bias_pixelnorm_lrelu(x, b).requires_grad
        assert not K.conv3x3_epilogue(x, w, b).requires_grad


# ---------------------------------------------------------------------------
# Gradients: the hand-written backwards against jax.grad of the pgx function
# ---------------------------------------------------------------------------

def _leaf(arr, dtype=None):
    t = torch.from_numpy(arr)
    return (t.to(dtype) if dtype else t).requires_grad_(True)


@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (1, 8, 8, 256)])
def test_bias_pixelnorm_lrelu_grads_match_pgx(pallas_interpret, shape):
    import jax
    import jax.numpy as jnp
    E = pallas_interpret["epilogue"]
    y, b, g = _rand(shape, 1), _rand(shape[-1:], 2), _rand(shape, 3)

    def j_loss(y_, b_):
        return jnp.sum(E.bias_pixelnorm_lrelu(y_, b_, 0.2) * g)

    want_y, want_b = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(y),
                                                      jnp.asarray(b))
    ty, tb = _leaf(y), _leaf(b)
    out = K.bias_pixelnorm_lrelu(ty, tb, 0.2)
    got_y, got_b = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                       (ty, tb))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               atol=1e-4, rtol=1e-4)   # a sum over rows


def test_bias_pixelnorm_lrelu_second_order_matches_pgx(pallas_interpret):
    """The gradient penalty's shape: a function of the input gradient,
    differentiated again with respect to y and b."""
    import jax
    import jax.numpy as jnp
    E = pallas_interpret["epilogue"]
    shape = (2, 4, 4, 128)
    y, b, g = _rand(shape, 1), _rand(shape[-1:], 2), _rand(shape, 3)

    def j_penalty(y_, b_):
        gy = jax.grad(lambda v: jnp.sum(
            E.bias_pixelnorm_lrelu(v, b_, 0.2) * g))(y_)
        norms = jnp.sqrt(jnp.sum(jnp.square(gy), axis=(1, 2, 3)))
        return jnp.mean(jnp.square(norms - 1.0))

    want_y, want_b = jax.grad(j_penalty, argnums=(0, 1))(jnp.asarray(y),
                                                         jnp.asarray(b))
    ty, tb = _leaf(y), _leaf(b)
    out = K.bias_pixelnorm_lrelu(ty, tb, 0.2)
    gy, = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ty,
                              create_graph=True)
    norms = gy.square().sum(dim=(1, 2, 3)).sqrt()
    got_y, got_b = torch.autograd.grad(((norms - 1.0) ** 2).mean(), (ty, tb))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("shape,slope", [((2, 4, 4, 128), 0.2),
                                         ((3, 4, 4, 64), 0.1)])
def test_pixel_norm_lrelu_grad_matches_pgx(shape, slope):
    """pgx's kernel B has no differentiation rule; its generator
    differentiates the XLA composition, which is the reference here."""
    import jax
    import jax.numpy as jnp
    from pgx.core import layers as JL
    x, g = _rand(shape, 3), _rand(shape, 4)
    want = jax.grad(lambda v: jnp.sum(
        JL.leaky_relu(JL.pixel_norm(v), slope) * g))(jnp.asarray(x))
    tx = _leaf(x)
    got, = torch.autograd.grad(
        (K.pixel_norm_lrelu(tx, slope) * torch.from_numpy(g)).sum(), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("shape,cout,pn", [((2, 8, 8, 128), 128, True),
                                           ((1, 8, 16, 128), 256, True),
                                           ((2, 8, 8, 128), 128, False)])
def test_conv3x3_epilogue_grads_match_pgx(pallas_interpret, shape, cout, pn):
    import jax
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    x = _rand(shape, 4)
    w = _rand((3, 3, shape[-1], cout), 5, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 6, 0.1)
    g = _rand(shape[:3] + (cout,), 7)
    op = C.make_conv3x3_epilogue(use_pixel_norm=pn)
    want = jax.grad(lambda *a: jnp.sum(op(*a) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = _leaf(x), _leaf(w), _leaf(b)
    out = K.conv3x3_epilogue(tx, tw, tb, use_pixel_norm=pn)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              (tx, tw, tb))
    for name, a, e in zip("xwb", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_conv3x3_epilogue_r_matches_pallas_emit_r(pallas_interpret):
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    shape, cout = (2, 8, 8, 128), 256
    x = _rand(shape, 4)
    w = _rand((3, 3, shape[-1], cout), 5, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 6, 0.1)
    want_y, want_r = C.conv3x3_epilogue_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True,
        emit_r=True)
    got_y, got_r = K.conv3x3_epilogue_with_r(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got_r.shape == (2, 8, 8, 1) and got_r.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL,
                               rtol=RTOL)
    y2, r2 = K.conv3x3_epilogue_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        return_r=True)
    assert torch.equal(y2, got_y) and torch.equal(r2, got_r)
    with pytest.raises(ValueError, match="pixel-norm"):
        K.conv3x3_epilogue_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), use_pixel_norm=False,
                               return_r=True)


def _f64(shape, seed, scale=1.0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape) * scale).requires_grad_(
            True)


def test_gradcheck_f64_rownorm_functions():
    """Finite differences in f64, first and second order, through the
    Functions of kernels A and B (their plain forward on the CPU)."""
    y, b, x = _f64((2, 2, 3, 8), 1), _f64((8,), 2, 0.3), _f64((2, 3, 8), 3)
    fa = lambda y_, b_: K.bias_pixelnorm_lrelu(y_, b_, 0.2)
    fb = lambda x_: K.pixel_norm_lrelu(x_, 0.1)
    assert torch.autograd.gradcheck(fa, (y, b))
    assert torch.autograd.gradgradcheck(fa, (y, b))
    assert torch.autograd.gradcheck(fb, (x,))
    assert torch.autograd.gradgradcheck(fb, (x,))


@pytest.mark.parametrize("pn", [True, False])
def test_gradcheck_f64_conv3x3_epilogue(pn):
    x, w, b = _f64((1, 3, 4, 8), 1), _f64((3, 3, 8, 8), 2, 0.2), _f64(
        (8,), 3, 0.3)
    f = lambda *a: K.conv3x3_epilogue(*a, use_pixel_norm=pn)
    assert f(x, w, b).dtype == torch.float64
    assert torch.autograd.gradcheck(f, (x, w, b))


def test_plain_versions_keep_f64_statistics():
    """An f64 input is normalized with f64 statistics (no pass through
    f32): the plain versions agree with numpy's f64 to 1e-13."""
    rng = np.random.RandomState(0)
    y, b = rng.randn(2, 3, 3, 16), rng.randn(16) * 0.3
    a = y + b
    want = a / np.sqrt((a * a).mean(-1, keepdims=True) + 1e-8)
    want = np.where(want < 0, 0.2 * want, want)
    ty, tb = torch.from_numpy(y), torch.from_numpy(b)
    got = K.bias_pixelnorm_lrelu_ref(ty, tb)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-13, rtol=0)
    got_b = K.pixel_norm_lrelu_ref(ty + tb)
    np.testing.assert_allclose(got_b.numpy(), want, atol=1e-13, rtol=0)
    x = torch.from_numpy(rng.randn(1, 4, 4, 8))
    w = torch.from_numpy(rng.randn(3, 3, 8, 16) * 0.2)
    pre = K.conv3x3_epilogue_ref(x, w, tb, use_pixel_norm=False, slope=1.0)
    got_c, r = K.conv3x3_epilogue_ref(x, w, tb, return_r=True)
    assert got_c.dtype == r.dtype == torch.float64
    pre = pre.numpy()
    want_c = pre / np.sqrt((pre * pre).mean(-1, keepdims=True) + 1e-8)
    want_c = np.where(want_c < 0, 0.2 * want_c, want_c)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-13, rtol=0)


def test_cpu_calls_do_not_count_launches():
    before = K.launch_counts()
    with torch.no_grad():
        K.pixel_norm_lrelu(torch.ones(1, 4, 4, 8))
    assert K.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

# bf16 tolerance: the kernel rounds once, the plain version after the conv,
# the bias and the norm; outputs are O(1..8), where a bf16 step is <= 2^-5
GPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.07}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(arr, dev, dtype):
    return torch.from_numpy(arr).to(dev, dtype)


# Kernel A's row mappings (A, B, A's backward): a row of C channels goes to
# a group of lanes, the power of two that covers its 16-byte vectors (8 bf16
# or 4 f32), a warp above 16 vectors.  Widths of 1 to 64 vectors, powers of
# two and not; rows that fill a block in part; "past_stride" is one stride
# of A's backward grid and 257 rows more (a partial last stride and block);
# and the 512px recipe's layers at batch 1.
A_WIDTHS = (8, 16, 24, 32, 40, 64, 96, 128, 200, 256, 264, 512)
A_ROW_SHAPES = [(rows, 1, 1, c) for c in A_WIDTHS
                for rows in (1, 7, 65, "past_stride")]
RECIPE_512_SHAPES = [(1, 4, 4, 512), (1, 8, 8, 512), (1, 16, 16, 512),
                     (1, 32, 32, 512), (1, 64, 64, 256), (1, 128, 128, 128),
                     (1, 256, 256, 64), (1, 512, 512, 32)]


def _a_shape(shape, dtype, grid="pgx_bias_pixelnorm_lrelu_bwd_partials"):
    """``shape`` with a "past_stride" row count resolved on this card: one
    stride of the grid that the library's entry ``grid`` gives (A's
    backward's or its second derivative's) and 257 rows more."""
    if shape[0] != "past_stride":
        return shape
    from pgx_torch.ops.kernels import build
    c = shape[-1]
    nvec = c * torch.finfo(dtype).bits // 128
    lanes = min(32, 1 << (nvec - 1).bit_length())
    blocks = getattr(build.load_library(), grid)(
        1 << 40, c, build.dtype_code(torch.empty(0, dtype=dtype)))
    assert blocks > 0
    return (blocks * (256 // lanes) + 257,) + tuple(shape[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 4, 512), (2, 64, 64, 256),
                                   (2, 17, 3, 40)] + RECIPE_512_SHAPES
                         + A_ROW_SHAPES)
def test_gpu_rownorm_kernels_match_plain(cuda, dtype, shape):
    shape = _a_shape(shape, dtype)
    y, b = _on(_rand(shape, 1), cuda, dtype), _on(_rand(shape[-1:], 2),
                                                   cuda, torch.float32)
    with torch.no_grad():
        got = K.bias_pixelnorm_lrelu(y, b)
        want = K.bias_pixelnorm_lrelu_ref(y, b)
        got_b = K.pixel_norm_lrelu(y, 0.1)
        want_b = K.pixel_norm_lrelu_ref(y, 0.1)
    torch.cuda.synchronize()
    tol = GPU_TOL[dtype]
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got_b.float() - want_b.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,pn", [
    ((4, 4, 4, 512), 512, True), ((2, 16, 16, 512), 512, True),
    ((2, 64, 64, 256), 256, True), ((1, 128, 128, 128), 128, True),
    ((3, 5, 7, 24), 40, False), ((1, 4, 4, 8), 8, True),
    # legacy_generator(channel=16)'s narrow widths
    ((2, 64, 64, 16), 16, True), ((2, 64, 64, 16), 8, True),
    ((2, 32, 32, 8), 8, True)])
def test_gpu_conv3x3_epilogue_matches_plain(cuda, dtype, shape, cout, pn):
    x = _on(_rand(shape, 4), cuda, dtype)
    w = _on(_rand((3, 3, shape[-1], cout), 5,
                  np.sqrt(2.0 / (9 * shape[-1]))), cuda, torch.float32)
    b = _on(_rand((cout,), 6, 0.1), cuda, torch.float32)
    with torch.no_grad():
        got = K.conv3x3_epilogue(x, w, b, use_pixel_norm=pn)
        want = K.conv3x3_epilogue_ref(x, w, b, use_pixel_norm=pn)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= GPU_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("emit_r", [False, True])
@pytest.mark.parametrize("shape,cout", [
    ((64, 4, 4, 512), 512), ((1, 4, 4, 512), 512),     # box (8, 4, 4)
    ((13, 4, 4, 512), 256),
    ((32, 8, 8, 512), 512), ((3, 8, 8, 256), 128),     # box (2, 8, 8)
    ((2, 16, 16, 512), 256), ((1, 12, 20, 64), 512)])  # (1, 8, 16), ragged
def test_gpu_conv3x3_epilogue_box_shapes_match_plain(cuda, shape, cout,
                                                     emit_r):
    """The bf16 kernel's pixel tile at the 4px and 8px stages: boxes that
    span several images, run past the batch (a batch-1 request), or past
    the image's edge, for every cluster size (C_out 128, 256, 512)."""
    x = _on(_rand(shape, 4), cuda, torch.bfloat16)
    w = _on(_rand((3, 3, shape[-1], cout), 5,
                  np.sqrt(2.0 / (9 * shape[-1]))), cuda, torch.float32)
    b = _on(_rand((cout,), 6, 0.1), cuda, torch.float32)
    with torch.no_grad():
        if emit_r:
            got, got_r = K.conv3x3_epilogue_with_r(x, w, b)
            want, want_r = K.conv3x3_epilogue_ref(x, w, b, return_r=True)
        else:
            got = K.conv3x3_epilogue(x, w, b)
            want = K.conv3x3_epilogue_ref(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() \
        <= GPU_TOL[torch.bfloat16]
    if emit_r:
        rel = ((got_r - want_r.float()).abs() / want_r.float()).max().item()
        assert rel <= 4e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 4, 4, 512), (8, 64, 64, 256),
                                   (2, 17, 3, 40), (9000, 1, 1, 64)]
                         + RECIPE_512_SHAPES + A_ROW_SHAPES)
def test_gpu_kernel_a_backward_matches_plain(cuda, dtype, shape):
    """A's backward kernel against its plain version: dy to one f32
    rounding (f32) or two bf16 steps (bf16) at the largest entry; db, an
    f32 sum over the rows in another order, to 1e-5 of its largest
    entry.  A second launch on the same inputs gives dy and db bit for
    bit (db's sums run in a fixed order)."""
    from pgx_torch.ops.kernels import epilogue as E
    shape = _a_shape(shape, dtype)
    y = _on(_rand(shape, 1), cuda, dtype)
    b = _on(_rand(shape[-1:], 2, 0.3), cuda, torch.float32)
    g = _on(_rand(shape, 3), cuda, dtype)
    before = K.launch_counts()["bias_pixelnorm_lrelu_bwd"]
    with torch.no_grad():
        got_dy, got_db = E._BiasPixelNormLreluGrad.apply(y, b, g, 0.2, 1e-8)
        want_dy, want_db = E.bias_pixelnorm_lrelu_backward_ref(y, b, g)
    torch.cuda.synchronize()
    assert K.launch_counts()["bias_pixelnorm_lrelu_bwd"] == before + 1
    assert got_dy.dtype == dtype and got_dy.shape == y.shape
    assert got_db.dtype == torch.float32 and got_db.shape == b.shape
    scale = want_dy.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (got_dy.float() - want_dy.float()).abs().max().item() \
        <= tol * scale
    db_scale = want_db.abs().max().item()
    assert (got_db - want_db).abs().max().item() <= 1e-5 * db_scale
    with torch.no_grad():
        again_dy, again_db = E._BiasPixelNormLreluGrad.apply(y, b, g, 0.2,
                                                             1e-8)
    assert torch.equal(again_dy, got_dy) and torch.equal(again_db, got_db)
    # the same kernel from autograd: one launch per first-order backward
    leaf = y.clone().requires_grad_(True)
    before = K.launch_counts()["bias_pixelnorm_lrelu_bwd"]
    torch.autograd.grad(K.bias_pixelnorm_lrelu(leaf, b), leaf, g)
    assert K.launch_counts()["bias_pixelnorm_lrelu_bwd"] == before + 1


@pytest.mark.gpu
def test_gpu_wrappers_reject_bad_inputs(cuda):
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiple of 8"):
            K.pixel_norm_lrelu(torch.zeros(1, 4, 4, 12, device=cuda))
        with pytest.raises(ValueError, match="contiguous"):
            K.pixel_norm_lrelu(
                torch.zeros(1, 8, 4, 4, device=cuda).permute(0, 2, 3, 1))
        with pytest.raises(TypeError):
            K.pixel_norm_lrelu(torch.zeros(1, 4, 4, 8, device=cuda,
                                           dtype=torch.float16))
        with pytest.raises(ValueError, match="C_out"):
            K.conv3x3_epilogue(torch.zeros(1, 4, 4, 8, device=cuda),
                               torch.zeros(3, 3, 8, 520, device=cuda),
                               torch.zeros(520, device=cuda))


# bf16 gradients: the Function's backward takes its statistics from bf16
# inputs in f32 and rounds the result to bf16 once; autograd through the
# plain version rounds at every op.  Gradients here are of order 1.
GPU_GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 0.06}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((32, 4, 4, 512), 512),
                                        ((4, 32, 32, 512), 512),
                                        ((2, 64, 64, 256), 256),
                                        ((1, 128, 128, 128), 128),
                                        ((3, 5, 7, 24), 40)])
def test_gpu_conv3x3_epilogue_r_matches_plain(cuda, dtype, shape, cout):
    x = _on(_rand(shape, 4), cuda, dtype)
    w = _on(_rand((3, 3, shape[-1], cout), 5,
                  np.sqrt(2.0 / (9 * shape[-1]))), cuda, torch.float32)
    b = _on(_rand((cout,), 6, 0.1), cuda, torch.float32)
    before = K.launch_counts()
    got_y, got_r = K.conv3x3_epilogue_with_r(x, w, b)
    after = K.launch_counts()
    want_y, want_r = K.conv3x3_epilogue_ref(x, w, b, return_r=True)
    torch.cuda.synchronize()
    assert after["conv3x3_epilogue_r"] == before["conv3x3_epilogue_r"] + 1
    assert after["conv3x3_epilogue"] == before["conv3x3_epilogue"]
    assert got_r.shape == shape[:3] + (1,) and got_r.dtype == torch.float32
    assert (got_y.float() - want_y.float()).abs().max().item() \
        <= GPU_TOL[dtype]
    # r against the plain version's: relative, since r = 1/rms(a); in bf16
    # the plain version takes its statistics from a conv output rounded to
    # bf16 (2^-9 relative per term)
    rel = ((got_r - want_r.float()).abs() / want_r.float()).max().item()
    assert rel <= (1e-4 if dtype == torch.float32 else 4e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_function_gradients_match_plain(cuda, dtype):
    tol = GPU_GRAD_TOL[dtype]

    def grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad((fn(*leaves).float() * g).sum(), leaves)

    y = _on(_rand((4, 16, 16, 256), 1), cuda, dtype)
    b = _on(_rand((256,), 2, 0.1), cuda, torch.float32)
    g = _on(_rand((4, 16, 16, 256), 3), cuda, torch.float32)
    for got, want in zip(grads(K.bias_pixelnorm_lrelu, (y, b), g),
                         grads(K.bias_pixelnorm_lrelu_ref, (y, b), g)):
        scale = max(want.float().abs().max().item(), 1.0)
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
    for got, want in zip(grads(K.pixel_norm_lrelu, (y,), g),
                         grads(K.pixel_norm_lrelu_ref, (y,), g)):
        assert (got.float() - want.float()).abs().max().item() <= tol
    x = _on(_rand((4, 16, 16, 128), 4), cuda, dtype)
    w = _on(_rand((3, 3, 128, 256), 5, np.sqrt(2.0 / (9 * 128))), cuda,
            torch.float32)
    before = K.launch_counts()["conv3x3_epilogue_r"]
    got_c = grads(K.conv3x3_epilogue, (x, w, b), g)
    assert K.launch_counts()["conv3x3_epilogue_r"] == before + 1
    for got, want in zip(got_c, grads(K.conv3x3_epilogue_ref, (x, w, b), g)):
        scale = max(want.float().abs().max().item(), 1.0)
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
def test_gpu_kernel_a_second_derivative_matches_plain(cuda):
    y = _on(_rand((4, 8, 8, 128), 1), cuda, torch.float32)
    b = _on(_rand((128,), 2, 0.1), cuda, torch.float32)
    g = _on(_rand((4, 8, 8, 128), 3), cuda, torch.float32)

    def penalty_grads(fn):
        ty = y.clone().requires_grad_(True)
        tb = b.clone().requires_grad_(True)
        gy, = torch.autograd.grad((fn(ty, tb) * g).sum(), ty,
                                  create_graph=True)
        norms = gy.square().sum(dim=(1, 2, 3)).sqrt()
        return torch.autograd.grad(((norms - 1.0) ** 2).mean(), (ty, tb))

    for got, want in zip(penalty_grads(K.bias_pixelnorm_lrelu),
                         penalty_grads(K.bias_pixelnorm_lrelu_ref)):
        scale = max(want.abs().max().item(), 1e-6)
        assert (got - want).abs().max().item() <= 1e-4 * scale


# The second derivative's row mappings: the 128px iteration's widths (128,
# 256, 512), narrow and odd widths (lane groups of 2 to 8 lanes) at row
# counts that fill a block in part, one stride of its grid and 257 rows more
# at 32 and 64 channels, and the 512px recipe's layers at batch 1.
A2_SHAPES = [(2, 16, 16, 128), (2, 16, 16, 256), (4, 8, 8, 512),
             (2, 17, 3, 40), (9000, 1, 1, 8), (2, 17, 3, 16),
             (3, 17, 5, 32), (1, 1, 1001, 64), (7, 1, 37, 24),
             ("past_stride", 1, 1, 32), ("past_stride", 1, 1, 64)] \
    + RECIPE_512_SHAPES


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", A2_SHAPES)
def test_gpu_kernel_a_second_order_kernel_matches_plain(cuda, dtype, shape):
    """The second-order kernel against its plain closed form at the
    channel counts of the iteration's calls (128, 256, 512), at the narrow
    and odd widths of its lane groups and at odd row counts: f32 to 1e-5
    of each output's largest entry, bf16 to two bf16 steps (d_b, an f32 sum
    in another order, to 1e-5 relative), for cotangents on dy, db and both
    and each pattern of needed outputs."""
    from pgx_torch.ops.kernels import epilogue as E
    shape = _a_shape(shape, dtype, "pgx_bias_pixelnorm_lrelu_bwd2_partials")
    y = _on(_rand(shape, 1), cuda, dtype)
    b = _on(_rand(shape[-1:], 2, 0.3), cuda, torch.float32)
    g = _on(_rand(shape, 3), cuda, dtype)
    ddy_all = _on(_rand(shape, 4), cuda, dtype)
    ddb_all = _on(_rand(shape[-1:], 5), cuda, torch.float32)
    for ddy, ddb in ((ddy_all, ddb_all), (ddy_all, None), (None, ddb_all)):
        for needs in ((True, True, True), (True, False, False),
                      (False, True, False), (False, False, True)):
            before = K.launch_counts()["bias_pixelnorm_lrelu_bwd2"]
            with torch.no_grad():
                got = E._BiasPixelNormLreluGrad2.apply(y, b, g, ddy, ddb,
                                                       0.2, 1e-8, needs)
            want = E.second_order_ref(y, b, g, ddy, ddb, 0.2, 1e-8, needs)
            torch.cuda.synchronize()
            assert K.launch_counts()["bias_pixelnorm_lrelu_bwd2"] == \
                before + 1
            for name, need, x, w in zip(("d_y", "d_b", "d_g"), needs, got,
                                        want):
                if not need:
                    assert x is None
                    continue
                assert x.dtype == w.dtype and x.shape == w.shape
                scale = w.float().abs().max().item()
                tol = (1e-5 * scale if dtype == torch.float32
                       or name == "d_b" else 2 * 2.0 ** (
                           np.floor(np.log2(max(scale, 1e-3))) - 7))
                err = (x.float() - w.float()).abs().max().item()
                assert err <= tol, (name, ddy is None, ddb is None, err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 17, 5, 32), ("past_stride", 1, 1, 32),
                                   ("past_stride", 1, 1, 64),
                                   (2, 16, 16, 128), (4, 8, 8, 512)])
def test_gpu_kernel_a_second_order_is_repeatable(cuda, dtype, shape):
    """Two launches of the second-order kernel on the same inputs give
    d_y, d_g and d_b bit for bit: d_b's column sums run in a fixed order on
    a grid that depends only on the card, the width and the dtype."""
    from pgx_torch.ops.kernels import epilogue as E
    shape = _a_shape(shape, dtype, "pgx_bias_pixelnorm_lrelu_bwd2_partials")
    y = _on(_rand(shape, 1), cuda, dtype)
    b = _on(_rand(shape[-1:], 2, 0.3), cuda, torch.float32)
    g = _on(_rand(shape, 3), cuda, dtype)
    ddy = _on(_rand(shape, 4), cuda, dtype)
    ddb = _on(_rand(shape[-1:], 5), cuda, torch.float32)
    with torch.no_grad():
        first, again = (E._BiasPixelNormLreluGrad2.apply(
            y, b, g, ddy, ddb, 0.2, 1e-8, (True, True, True))
            for _ in range(2))
    torch.cuda.synchronize()
    for x, w in zip(first, again):
        assert torch.equal(x, w)


@pytest.mark.gpu
def test_gpu_kernel_a_backward_of_backward_launches_the_kernel(cuda):
    """A's backward under create_graph, differentiated again: one launch of
    the second-order kernel per outer backward, the values the plain
    version's."""
    y = _on(_rand((4, 8, 8, 128), 1), cuda, torch.float32)
    b = _on(_rand((128,), 2, 0.1), cuda, torch.float32)
    g = _on(_rand((4, 8, 8, 128), 3), cuda, torch.float32)

    def penalty_grads(fn):
        ty, tb = y.clone().requires_grad_(True), b.clone().requires_grad_(True)
        gy, = torch.autograd.grad((fn(ty, tb) * g).sum(), ty,
                                  create_graph=True)
        return torch.autograd.grad(gy.square().sum(), (ty, tb))

    before = K.launch_counts()["bias_pixelnorm_lrelu_bwd2"]
    got = penalty_grads(K.bias_pixelnorm_lrelu)
    assert K.launch_counts()["bias_pixelnorm_lrelu_bwd2"] == before + 1
    for a, e in zip(got, penalty_grads(K.bias_pixelnorm_lrelu_ref)):
        assert (a - e).abs().max().item() <= 1e-4 * e.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("with_db", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 4, 512), (8, 64, 64, 256),
                                   (8, 512, 512, 64), (8, 512, 512, 32),
                                   (2, 17, 3, 40), (9000, 1, 1, 8),
                                   (3, 5, 7, 136)])
def test_gpu_kernel_a_tangent_matches_plain(cuda, dtype, shape, with_db):
    """A's tangent kernel against its plain version (pgx's rule in torch
    ops) at the recipe's channel counts (512 at 4px ... 32 at 512px), at
    odd row counts and at widths whose vectors do not fill their lane group
    (40, 136 channels): f32 to 1e-5 of the largest output, bf16 to two
    bf16 steps; one launch each."""
    from pgx_torch.ops.kernels import epilogue as E
    y = _on(_rand(shape, 1), cuda, dtype)
    b = _on(_rand(shape[-1:], 2, 0.3), cuda, dtype)
    dy = _on(_rand(shape, 3), cuda, dtype)
    db = _on(_rand(shape[-1:], 4), cuda, dtype) if with_db else None
    before = K.launch_counts()["bias_pixelnorm_lrelu_jvp"]
    with torch.no_grad():
        got = E.bias_pixelnorm_lrelu_tangent(y, b, dy, db)
    want = E.bias_pixelnorm_lrelu_jvp_ref(y, b, dy, db)
    torch.cuda.synchronize()
    assert K.launch_counts()["bias_pixelnorm_lrelu_jvp"] == before + 1
    assert got.dtype == dtype and got.shape == y.shape
    scale = want.float().abs().max().item()
    tol = (1e-5 * scale if dtype == torch.float32
           else 2 * 2.0 ** (np.floor(np.log2(max(scale, 1e-3))) - 7))
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_kernel_a_tangent_takes_misaligned_views(cuda, dtype):
    from pgx_torch.ops.kernels import epilogue as E
    y = _misaligned((2, 5, 5, 40), dtype, cuda, 1)
    dy = _misaligned((2, 5, 5, 40), dtype, cuda, 2)
    b = _on(_rand((40,), 3, 0.1), cuda, torch.float32)
    before = K.launch_counts()["bias_pixelnorm_lrelu_jvp"]
    with torch.no_grad():
        got = E.bias_pixelnorm_lrelu_tangent(y, b, dy)
    want = E.bias_pixelnorm_lrelu_jvp_ref(y, b, dy)
    torch.cuda.synchronize()
    assert K.launch_counts()["bias_pixelnorm_lrelu_jvp"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= GPU_TOL[dtype]


@pytest.mark.gpu
def test_gpu_kernel_a_tangent_launches_from_a_jvp_penalty(cuda):
    """A two-conv block under forward AD, its tangent differentiated in
    reverse mode (the jvp penalty's shape): one tangent, one backward for
    the tangent's transpose, one for the primal chain and one second
    derivative per A, and the gradients of the plain versions (f32,
    1e-4 of the largest entry)."""
    from pgx_torch.core import layers as L
    import torch.autograd.forward_ad as fwAD
    x = _on(_rand((4, 8, 8, 64), 1), cuda, torch.float32)
    u = _on(_rand((4, 8, 8, 64), 2), cuda, torch.float32)
    convs = [(_on(_rand((3, 3, 64, 64), 3 + i), cuda, torch.float32)
              .requires_grad_(True),
              _on(_rand((64,), 5 + i, 0.1), cuda, torch.float32)
              .requires_grad_(True)) for i in range(2)]

    def jv(epilogue):
        with fwAD.dual_level():
            h = fwAD.make_dual(x, u)
            for w, b in convs:
                h = epilogue(L.equal_conv2d(w, b, h, padding=1, bias=False),
                             b)
            t = fwAD.unpack_dual(h.square().sum()).tangent
        return torch.autograd.grad(t, [p for c in convs for p in c])

    names = ("bias_pixelnorm_lrelu_jvp", "bias_pixelnorm_lrelu_bwd",
             "bias_pixelnorm_lrelu_bwd2")
    before = {n: K.launch_counts()[n] for n in names}
    got = jv(K.bias_pixelnorm_lrelu)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert {n: after[n] - before[n] for n in names} == {
        "bias_pixelnorm_lrelu_jvp": 2, "bias_pixelnorm_lrelu_bwd": 4,
        "bias_pixelnorm_lrelu_bwd2": 2}
    for a, e in zip(got, jv(K.bias_pixelnorm_lrelu_ref)):
        assert (a - e).abs().max().item() <= 1e-4 * e.abs().max().item()


def _misaligned(shape, dtype, dev, seed):
    """A contiguous view of ``shape`` whose data pointer is one element
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 1, dtype=dtype, device=dev)
    flat[1:] = _on(_rand((n,), seed), dev, dtype)
    view = flat[1:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_misaligned_views_are_copied_and_launched(cuda, dtype):
    """A, A's backward, B, C, D, E and F take a contiguous view whose
    pointer is not 16-byte aligned (copied first) and match their plain
    versions."""
    from pgx_torch.ops import bias_act
    from pgx_torch.ops.kernels import epilogue as E
    y = _misaligned((2, 5, 5, 40), dtype, cuda, 1)
    g = _misaligned((2, 5, 5, 40), dtype, cuda, 5)
    b = _on(_rand((40,), 2, 0.1), cuda, torch.float32)
    w = _on(_rand((3, 3, 40, 24), 3, 0.1), cuda, torch.float32)
    img = _misaligned((2, 3, 24, 36), dtype, cuda, 4)
    taps = _fir_taps(12)
    tol = GPU_TOL[dtype]
    cases = {
        "bias_pixelnorm_lrelu": (lambda: K.bias_pixelnorm_lrelu(y, b),
                                 lambda: K.bias_pixelnorm_lrelu_ref(y, b)),
        "bias_pixelnorm_lrelu_bwd": (
            lambda: E._BiasPixelNormLreluGrad.apply(y, b, g, 0.2, 1e-8)[0],
            lambda: E.bias_pixelnorm_lrelu_backward_ref(y, b, g)[0]),
        "pixel_norm_lrelu": (lambda: K.pixel_norm_lrelu(y),
                             lambda: K.pixel_norm_lrelu_ref(y)),
        "conv3x3_epilogue": (lambda: K.conv3x3_epilogue(y, w, b[:24]),
                             lambda: K.conv3x3_epilogue_ref(y, w, b[:24])),
        "upfirdn2d": (lambda: K.upfirdn2d_separable(y, taps, 2, 1,
                                                    (6, 5, 6, 5)),
                      lambda: K.upfirdn2d_ref(y, taps, 2, 1, (6, 5, 6, 5))),
        "bias_act": (lambda: bias_act(y, b, act="lrelu"),
                     lambda: K.bias_act_ref(y, b, act="lrelu")),
        "shift_1d": (lambda: K.shift_1d(img, torch.full((2, 36), 2.5,
                                                        device=cuda), 2),
                     lambda: K.shift_1d_ref(img, torch.full(
                         (2, 36), 2.5, device=cuda), 2)),
    }
    for name, (kern, plain) in cases.items():
        before = K.launch_counts()[name]
        with torch.no_grad():
            got, want = kern(), plain()
        torch.cuda.synchronize()
        assert K.launch_counts()[name] == before + 1, name
        assert (got.float() - want.float()).abs().max().item() <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_unsupported_width_model_forward(cuda, dtype):
    """legacy_generator(channel=16) at 128px: its 4-channel stages take the
    torch ops and cuDNN, the others the kernels; the output is finite and
    matches the plain versions': in f32 to 1e-3 of the largest output; in
    bf16 in the mean, to 2e-2 of it, because a pixel norm over 4 channels
    in bf16 turns one rounding of a small pixel into a different pixel
    (single outputs differ by up to 0.6 there)."""
    from pgx_torch.core import layers as TL
    from pgx_torch.models import generator as TG
    from pgx_torch.models import zoo
    from pgx_torch.models.generator import Generator, init_generator
    cfg = zoo.legacy_generator(z_dim=16, channel=16, max_step=5,
                               dtype=str(dtype).removeprefix("torch."))
    gen = Generator.from_jax_params(cfg, init_generator(cfg, seed=0), cuda)
    z = torch.randn(4, 16, device=cuda)
    K.reset_launch_counts()
    with torch.no_grad():
        got = gen(z, step=5).float()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["pixel_norm_lrelu"] == 1 and counts["conv3x3_epilogue"] > 0
    assert got.shape == (4, 128, 128, 3) and bool(torch.isfinite(got).all())
    plain = {TL: ("bias_pixelnorm_lrelu", "conv3x3_epilogue"),
             TG: ("pixel_norm_lrelu",)}
    saved = {(m, n): getattr(m, n) for m, ns in plain.items() for n in ns}
    try:
        for (m, n) in saved:
            setattr(m, n, getattr(K, n + "_ref"))
        with torch.no_grad():
            want = gen(z, step=5).float()
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    scale = want.abs().max().item()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-3 * scale
    else:
        assert (got - want).abs().mean().item() <= 2e-2 * scale


# ---------------------------------------------------------------------------
# On the card: kernels F (shift_1d), D (upfirdn2d) and E (bias_act)
# ---------------------------------------------------------------------------

# one bf16 step at outputs of O(1..4): the kernels and their plain versions
# both compute in f32 and round once, so they differ by at most one rounding
# of a value whose f32 sums ran in another order
FDE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis,scale", [
    ((2, 3, 64, 128), 3, 40.0), ((2, 3, 64, 128), 2, 40.0),
    ((2, 3, 52, 130), 3, 30.0), ((1, 2, 64, 101), 2, 20.0),
    ((2, 3, 576, 896), 3, 200.0), ((2, 3, 576, 268), 2, 200.0),   # 128px
    ((1, 3, 1088, 524), 2, 400.0), ((1, 3, 2112, 1036), 2, 3000.0),
    ((1, 1, 7, 5), 3, 0.0)])
def test_gpu_shift_1d_matches_plain(cuda, dtype, shape, axis, scale):
    img = _on(_rand(shape, 1), cuda, dtype)
    lines = shape[2] if axis == 3 else shape[3]
    shift = _on(_rand((shape[0], lines), 2, scale), cuda, torch.float32)
    before = K.launch_counts()["shift_1d"]
    with torch.no_grad():
        got = K.shift_1d(img, shift, axis)
        want = K.shift_1d_ref(img, shift, axis)
    torch.cuda.synchronize()
    assert K.launch_counts()["shift_1d"] == before + 1
    assert got.dtype == dtype and got.shape == img.shape
    assert (got.float() - want.float()).abs().max().item() <= FDE_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [2, 3])
def test_gpu_shift_1d_warp_shapes_and_crop_view(cuda, dtype, axis):
    """The two 128px warp calls at batch 32 with the warp's shifts (gamma
    times the centred line), the y-shear also on the column crop of the
    x-shear's output, read in place."""
    b, c, r, vx, n = 32, 3, 576, 896, 268
    big = _on(_rand((b, c, r, vx), 1), cuda, dtype)
    gamma = _on(_rand((b, 1), 2, 0.5), cuda, torch.float32).clamp(-1, 1)
    lines = r if axis == 3 else n
    shift = gamma * (torch.arange(lines, device=cuda) - (lines / 2 - 0.5))
    imgs = [big] if axis == 3 else [big[..., 314:314 + n],
                                    big[..., 314:314 + n].contiguous()]
    for img in imgs:
        before = K.launch_counts()["shift_1d"]
        with torch.no_grad():
            got = K.shift_1d(img, shift, axis)
            want = K.shift_1d_ref(img, shift, axis)
        torch.cuda.synchronize()
        assert K.launch_counts()["shift_1d"] == before + 1
        assert got.is_contiguous() and got.shape == img.shape
        assert (got.float() - want.float()).abs().max().item() <= \
            FDE_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [2, 3])
def test_gpu_shift_1d_backward_launches_the_kernel(cuda, axis):
    img = _on(_rand((2, 3, 48, 64), 1), cuda, torch.float32)
    lines = 48 if axis == 3 else 64
    shift = _on(_rand((2, lines), 2, 15.0), cuda, torch.float32)
    g = _on(_rand((2, 3, 48, 64), 3), cuda, torch.float32)
    x = img.clone().requires_grad_(True)
    before = K.launch_counts()["shift_1d"]
    got, = torch.autograd.grad(K.shift_1d(x, shift, axis), x, g)
    assert K.launch_counts()["shift_1d"] == before + 2     # forward, backward
    x2 = img.clone().requires_grad_(True)
    want, = torch.autograd.grad(K.shift_1d_ref(x2, shift, axis), x2, g)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def _fir_taps(n):
    """n random taps whose outputs stay O(1): 12 taps in [0, 1/3), the
    spread scaled by sqrt(12 / n) for other counts."""
    return np.random.RandomState(0).rand(n) / 3.0 * (12 / n) ** 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ntaps,up,down,pads,flip", [
    ((2, 16, 17, 3), 12, 1, 1, (0, 0, 0, 0), False),
    ((2, 8, 9, 3), 12, 2, 1, (2, 1, 2, 1), False),
    ((2, 17, 16, 3), 12, 1, 2, (1, 2, 2, 1), True),
    ((2, 8, 8, 5), 12, 2, 2, (-1, 2, 0, -1), False),
    ((2, 94, 94, 3), 12, 2, 1, (6, 5, 6, 5), False),     # the gather path's
    ((2, 76, 76, 3), 12, 1, 2, (-7, -7, -7, -7), True),  # two calls, 32px
    ((1, 20, 300, 1), 12, 1, 2, (-2, -1, -2, -1), False),
    # the gather path's two calls at 128px, batch 2, and their backward
    ((2, 382, 382, 3), 12, 2, 1, (6, 5, 6, 5), False),
    ((2, 268, 268, 3), 12, 1, 2, (-1, -1, -1, -1), True),
    ((2, 764, 764, 3), 12, 1, 2, (5, 5, 5, 5), True),
    ((2, 128, 128, 3), 12, 2, 1, (12, 11, 12, 11), False),
    # the ops layer's block: 4 taps, C = 64, an odd leading pad; C split
    ((2, 64, 64, 64), 4, 2, 1, (3, 2, 3, 2), False),
    ((2, 130, 130, 64), 4, 1, 2, (1, 1, 1, 1), True),
    ((1, 19, 23, 130), 4, 2, 1, (3, 2, 2, 3), False),
    # C = 1 and 5; smaller than one tile; 7 and 64 taps; up = down = 2
    ((2, 45, 37, 1), 12, 2, 1, (7, 4, 5, 6), False),
    ((2, 41, 38, 5), 12, 1, 2, (-7, -3, -2, -9), True),
    ((1, 3, 2, 3), 12, 2, 1, (6, 5, 6, 5), False),
    ((2, 30, 29, 3), 7, 2, 1, (3, 3, 2, 4), False),
    ((2, 19, 17, 5), 7, 2, 2, (3, -2, -3, 4), True),
    ((1, 80, 72, 64), 64, 1, 2, (31, 32, 30, 33), False),
    ((2, 40, 38, 3), 64, 2, 1, (33, 30, 32, 31), True),
    ((2, 33, 31, 70), 4, 2, 2, (1, 2, 2, 1), False)])
def test_gpu_upfirdn2d_matches_plain(cuda, dtype, shape, ntaps, up, down,
                                     pads, flip):
    taps = _fir_taps(ntaps)
    x = _on(_rand(shape, 4), cuda, dtype)
    before = K.launch_counts()["upfirdn2d"]
    with torch.no_grad():
        got = K.upfirdn2d_separable(x, taps, up, down, pads, flip)
        want = K.upfirdn2d_ref(x, taps, up, down, pads, flip)
    torch.cuda.synchronize()
    assert K.launch_counts()["upfirdn2d"] == before + 1    # one per call
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= FDE_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("up,down,pads", [(2, 1, (6, 5, 6, 5)),
                                          (1, 2, (-7, -7, -7, -7)),
                                          (2, 2, (1, 2, 0, 3))])
def test_gpu_upfirdn2d_backward_launches_the_kernel(cuda, up, down, pads):
    taps = np.random.RandomState(0).rand(12) / 3.0
    x = _on(_rand((2, 40, 42, 3), 4), cuda, torch.float32)
    x1, x2 = (x.clone().requires_grad_(True) for _ in range(2))
    y = K.upfirdn2d_separable(x1, taps, up, down, pads)
    g = torch.randn_like(y)
    before = K.launch_counts()["upfirdn2d"]
    got, = torch.autograd.grad(y, x1, g)
    assert K.launch_counts()["upfirdn2d"] == before + 1
    want, = torch.autograd.grad(K.upfirdn2d_ref(x2, taps, up, down, pads),
                                x2, g)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clamp", [None, 1.5])
@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "tanh",
                                 "sigmoid", "elu", "selu", "softplus",
                                 "swish"])
def test_gpu_bias_act_matches_plain(cuda, dtype, act, clamp):
    from pgx_torch.ops import bias_act
    for shape in ((4, 16, 16, 256), (3, 5, 7, 3), (1, 1, 1, 5)):
        x = _on(_rand(shape, 5, 2.0), cuda, dtype)
        b = _on(_rand(shape[-1:], 6), cuda, torch.float32)
        before = K.launch_counts()["bias_act"]
        with torch.no_grad():
            got = bias_act(x, b, act=act, clamp=clamp)
            want = K.bias_act_ref(x, b, act=act, clamp=clamp)
            got0 = bias_act(x, None, act=act, alpha=0.3, gain=0.7)
            want0 = K.bias_act_ref(x, None, act=act, alpha=0.3, gain=0.7)
        torch.cuda.synchronize()
        assert K.launch_counts()["bias_act"] == before + 2
        assert got.dtype == dtype and got.shape == x.shape
        # outputs reach |x| * sqrt(2) ~ 12 here: three bf16 steps at 8..16
        tol = 1e-5 if dtype == torch.float32 else 2 ** -4
        assert (got.float() - want.float()).abs().max().item() <= tol
        assert (got0.float() - want0.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["lrelu", "tanh", "swish", "softplus"])
def test_gpu_bias_act_gradients_match_plain(cuda, act):
    """First and second order: the Function's plain-op backward behind the
    kernel's forward against autograd through the plain version."""
    from pgx_torch.ops import bias_act
    x = _on(_rand((4, 8, 8, 64), 7), cuda, torch.float32)
    b = _on(_rand((64,), 8, 0.5), cuda, torch.float32)
    g = _on(_rand((4, 8, 8, 64), 9), cuda, torch.float32)

    def both_orders(fn):
        tx, tb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        first = torch.autograd.grad((fn(tx, tb) * g).sum(), (tx, tb),
                                    create_graph=True)
        pen = (first[0].square() * (1.0 + g)).sum()
        second = (torch.autograd.grad(pen, (tx, tb)) if pen.requires_grad
                  else ())
        return [*first, *second]

    got = both_orders(lambda x_, b_: bias_act(x_, b_, act=act, clamp=1.2))
    want = both_orders(lambda x_, b_: K.bias_act_ref(x_, b_, act=act,
                                                     clamp=1.2))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, e in zip(got, want):
        scale = max(e.abs().max().item(), 1.0)
        assert (a - e).abs().max().item() <= 2e-4 * scale


@pytest.mark.gpu
def test_gpu_new_wrappers_reject_bad_inputs(cuda):
    from pgx_torch.ops import bias_act, upfirdn2d
    with torch.no_grad():
        with pytest.raises(TypeError):
            K.shift_1d(torch.zeros(1, 1, 4, 4, device=cuda,
                                   dtype=torch.float64),
                       torch.zeros(1, 4, device=cuda), 3)
        with pytest.raises(TypeError):
            bias_act(torch.zeros(2, 4, device=cuda, dtype=torch.float16))
        # the wrapper takes 1 to 64 taps; upfirdn2d sends longer filters to
        # the grouped conv (tests/test_torch_routing.py)
        with pytest.raises(ValueError, match="taps"):
            K.upfirdn2d_separable(torch.zeros(1, 80, 80, 1, device=cuda),
                                  np.ones(65))
        before = K.launch_counts()["upfirdn2d"]
        assert upfirdn2d(torch.zeros(1, 80, 80, 1, device=cuda),
                         np.ones(65)).shape == (1, 16, 16, 1)
        assert K.launch_counts()["upfirdn2d"] == before
        with pytest.raises(ValueError, match="1 or 2"):
            K.upfirdn2d_separable(torch.zeros(1, 8, 8, 1, device=cuda),
                                  [1.0, 1.0], up=3)


@pytest.mark.gpu
def test_gpu_ada_state_defaults_to_the_card(cuda):
    """``init_ada_state()`` with no device lands on the card, and updates
    from CUDA logits keep every leaf there, across a trigger."""
    from pgx_torch.augment import AdaConfig, ada_update, init_ada_state
    state = init_ada_state()
    assert all(v.device.type == "cuda" for v in state.values())
    cfg = AdaConfig(ada_length=1000)
    for _ in range(5):
        state = ada_update(state, torch.ones(8, device=cuda), cfg, 8)
        assert all(v.device.type == "cuda" and v.dtype == torch.float32
                   for v in state.values())
    assert state["p"].item() > 0.0 and state["count"].item() == 8.0
    with pytest.raises(ValueError, match="is on cpu"):
        ada_update(init_ada_state(device="cpu"),
                   torch.ones(8, device=cuda), cfg, 8)
