"""pgx_torch's ops layer (upfirdn2d with kernel D, bias_act with kernel E,
fma, conv2d_resample, grid_sample) against pgx on the CPU.

On the CPU the kernel wrappers take their plain versions.  Each op is held
against pgx's plain (lax) path and against pgx's Pallas kernel run in
interpret mode on the same numpy inputs, in f32.  Tolerances: 1e-5
(absolute and relative) for the FIR ops and bias_act: the same f32
arithmetic summed in another order, the exponentials from another libm;
gradients likewise.  ``grid_sample``: 1e-5, the coordinates are f32 in both
packages.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import pgx.ops as jops
import pgx.ops.pallas as jpallas
import pgx_torch.ops as tops
from pgx.augment.pipe import WAVELETS
from pgx.ops.bias_act import activation_funcs as j_acts
from pgx_torch.ops.kernels import (bias_act_ref, launch_counts,
                                   upfirdn2d_ref, upfirdn2d_separable)
from pgx_torch.ops.kernels import upfirdn2d as tk_upfirdn

ATOL = RTOL = 1e-5
ACTS = list(j_acts)


def _rand(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def pallas_route(monkeypatch):
    """pgx's dispatchers sent through its Pallas kernels, every pallas_call
    in interpreter mode (the fixture of tests/test_pallas_kernels.py)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import pgx.ops.pallas.kernels as K
    monkeypatch.setattr(K.pl, "pallas_call", patched)
    monkeypatch.setattr(jpallas, "pallas_enabled", lambda: True)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# upfirdn2d (kernel D's wrapper)
# ---------------------------------------------------------------------------

GRID = [(1, 1, 0), (1, 1, 3), (1, 2, 1), (2, 1, 0), (2, 1, 2), (2, 2, 1),
        (1, 2, (2, 1, 1, 2)), (2, 1, (1, 3, 2, 0)), (1, 2, (-2, -1, -2, -1)),
        (2, 2, (-1, 2, 0, -1))]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("up,down,pad", GRID)
def test_upfirdn2d_separable_matches_pgx(up, down, pad, flip):
    x = _rand((2, 8, 9, 3), seed=up * 7 + down)
    f = np.asarray(jops.setup_filter([1, 3, 3, 2], separable=True))
    want = jops.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down,
                          padding=pad, flip_filter=flip, gain=1.5)
    got = tops.upfirdn2d(_t(x), f, up=up, down=down, padding=pad,
                         flip_filter=flip, gain=1.5)
    _close(got, want)


@pytest.mark.parametrize("up,down,pad", GRID)
def test_upfirdn2d_matches_pallas_interpret(pallas_route, up, down, pad):
    x = _rand((2, 8, 8, 3), seed=up * 7 + down)
    f = np.asarray(jops.setup_filter([1, 3, 3, 1], separable=True))
    want = jops.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down,
                          padding=pad, gain=1.5)
    got = tops.upfirdn2d(_t(x), _t(f), up=up, down=down, padding=pad,
                         gain=1.5)
    _close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("route", ["lax", "pallas"])
def test_sym6_calls_of_the_gather_path(route, request):
    """upsample2d, then downsample2d with the negative padding and flipped
    filter the ADA gather path uses, plus filter2d."""
    if route == "pallas":
        request.getfixturevalue("pallas_route")
    f = np.asarray(jops.setup_filter(WAVELETS["sym6"], separable=True))
    assert f.ndim == 1 and len(f) == 12
    x = _rand((1, 12, 14, 2), seed=3)
    _close(tops.upsample2d(_t(x), f), jops.upsample2d(jnp.asarray(x),
                                                      jnp.asarray(f)),
           rtol=1e-4)
    _close(tops.downsample2d(_t(x), f),
           jops.downsample2d(jnp.asarray(x), jnp.asarray(f)), rtol=1e-4)
    big = _rand((1, 28, 28, 2), seed=4)
    _close(tops.downsample2d(_t(big), f, down=2, padding=-6,
                             flip_filter=True),
           jops.downsample2d(jnp.asarray(big), jnp.asarray(f), down=2,
                             padding=-6, flip_filter=True), rtol=1e-4)
    _close(tops.filter2d(_t(x), f, gain=2.0),
           jops.filter2d(jnp.asarray(x), jnp.asarray(f), gain=2.0),
           rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(f=[1, 3, 3, 1]),                            # 2-D by outer product
    dict(f=[[1, 2, 1], [2, 4, 1], [0, 2, 1]], flip_filter=True),
    dict(f=[1, 3, 3, 1], up=2, padding=(2, 1, 2, 1), gain=4.0),
    dict(f=[1, 2, 1], down=3, padding=1),
    dict(f=None),
], ids=["outer", "2d-flip", "2d-up", "down3", "none"])
def test_upfirdn2d_conv_route_matches_pgx(kw):
    """2-D filters and factors outside {1, 2}: the grouped-conv route."""
    kw = dict(kw)
    f = kw.pop("f")
    sep = kw.get("down") == 3
    jf = None if f is None else jops.setup_filter(f, separable=sep or None)
    tf = None if f is None else tops.setup_filter(f, separable=sep or None)
    if f is not None:
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    x = _rand((2, 9, 10, 3), seed=5)
    before = launch_counts()
    _close(tops.upfirdn2d(_t(x), tf, **kw),
           jops.upfirdn2d(jnp.asarray(x), jf, **kw))
    assert launch_counts() == before


def test_setup_filter_matches_pgx():
    for kw in (dict(f=[1, 3, 3, 1]), dict(f=[1, 3, 3, 1], separable=True),
               dict(f=WAVELETS["sym6"]), dict(f=None),
               dict(f=[1, 2, 3], flip_filter=True, gain=4.0),
               dict(f=[[1, 2], [3, 4]], normalize=False, flip_filter=True)):
        got, want = tops.setup_filter(**kw), np.asarray(
            jops.setup_filter(**kw))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("up,down,pad,size", [
    (2, 1, (2, 1, 2, 1), (8, 8)), (1, 2, (1, 1, 1, 1), (9, 11)),
    (1, 2, (-2, -1, -2, -1), (12, 13)), (2, 2, (1, 2, 0, 3), (7, 6)),
    (1, 1, (3, 0, 1, 2), (5, 6))])
def test_upfirdn2d_gradient_matches_pgx(up, down, pad, size):
    """The Function's backward (the transposed upfirdn) against jax.grad
    of pgx's lax path and against autograd through the plain version."""
    x = _rand((2, *size, 3), seed=6)
    f = np.asarray(jops.setup_filter([1, 3, 3, 2], separable=True))

    def j_loss(v):
        return jnp.sum(jnp.square(jops.upfirdn2d(
            v, jnp.asarray(f), up=up, down=down, padding=pad, gain=4.0)))

    want = jax.grad(j_loss)(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y = tops.upfirdn2d(tx, f, up=up, down=down, padding=pad, gain=4.0)
    got, = torch.autograd.grad(y.square().sum(), tx)
    _close(got, want, atol=1e-4, rtol=1e-4)

    tx2 = _t(x).requires_grad_(True)
    y2 = upfirdn2d_ref(tx2, (f * 2.0).tolist(), up, down, pad)
    ref, = torch.autograd.grad(y2.square().sum(), tx2)
    _close(got, ref.numpy(), atol=1e-4, rtol=1e-4)


def test_upfirdn2d_differentiates_twice_in_f64():
    x = _t(_rand((1, 5, 6, 2), seed=7, dtype=np.float64)).requires_grad_(True)
    taps = (0.3, 0.9, 0.7, 0.1)
    fn = lambda v: upfirdn2d_separable(v, taps, 2, 1, (2, 1, 2, 1))
    assert fn(x).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    fn2 = lambda v: upfirdn2d_separable(v, taps, 1, 2, (-1, 1, 0, 2), True)
    assert torch.autograd.gradcheck(fn2, (x,))


def test_upfirdn2d_out_len_and_empty():
    assert tk_upfirdn.out_len(8, 4, 2, 1, 2, 1) == 16
    assert tk_upfirdn.out_len(28, 12, 1, 2, -1, -1) == 8
    assert tk_upfirdn.out_len(2, 12, 1, 1, 0, 0) == 0
    y = upfirdn2d_separable(torch.zeros(1, 2, 20, 1), [1.0] * 12)
    assert y.shape == (1, 0, 9, 1)


# ---------------------------------------------------------------------------
# bias_act (kernel E's wrapper)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clamp", [None, 1.5])
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_pgx(act, clamp):
    x, b = _rand((2, 5, 5, 7), seed=11) * 2, _rand((7,), seed=12)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act,
                         clamp=clamp)
    got = tops.bias_act(_t(x), _t(b), act=act, clamp=clamp)
    assert got.dtype == torch.float32
    _close(got, want)
    _close(bias_act_ref(_t(x), _t(b), act=act, clamp=clamp), want)
    # no bias; explicit alpha and gain
    _close(tops.bias_act(_t(x), None, act=act, alpha=0.3, gain=0.7,
                         clamp=clamp),
           jops.bias_act(jnp.asarray(x), None, act=act, alpha=0.3, gain=0.7,
                         clamp=clamp))


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_pallas_interpret(pallas_route, act):
    x, b = _rand((2, 5, 5, 7), seed=11), _rand((7,), seed=12)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=1.5)
    got = tops.bias_act(_t(x), _t(b), act=act, clamp=1.5)
    _close(got, want)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_bias_act_other_dim_takes_the_plain_chain(dim):
    x = _rand((4, 5, 6, 3), seed=13)
    b = _rand((x.shape[dim],), seed=14)
    _close(tops.bias_act(_t(x), _t(b), dim=dim, act="swish", clamp=2.0),
           jops.bias_act(jnp.asarray(x), jnp.asarray(b), dim=dim,
                         act="swish", clamp=2.0))


def test_bias_act_registry_matches_pgx():
    from pgx_torch.ops import activation_funcs as t_acts
    assert list(t_acts) == ACTS and len(ACTS) == 9
    for name, spec in t_acts.items():
        assert spec.def_alpha == j_acts[name].def_alpha
        assert spec.def_gain == j_acts[name].def_gain
        # the derivative the backward is built from depends on x exactly
        # where pgx's registry says there is a second derivative
        probe = torch.linspace(-2.0, 2.0, 9, requires_grad=True)
        assert (spec.dfunc(probe, spec.def_alpha).requires_grad
                == j_acts[name].has_2nd_grad)
    assert sorted(s.code for s in t_acts.values()) == list(range(9))
    with pytest.raises(ValueError, match="clamp"):
        tops.bias_act(torch.zeros(2, 3), clamp=-1.0)
    with pytest.raises(ValueError, match="bias shape"):
        tops.bias_act(torch.zeros(2, 3), torch.zeros(2))
    with pytest.raises(KeyError):
        tops.bias_act(torch.zeros(2, 3), act="gelu")


@pytest.mark.parametrize("clamp", [None, 0.9])
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_gradients_match_jax(act, clamp):
    """First order in x and b, and a second-order (penalty-shaped)
    gradient, against jax.grad of pgx's lax chain."""
    x, b = _rand((3, 4, 6), seed=15), _rand((6,), seed=16) * 0.5
    g = _rand((3, 4, 6), seed=17)

    def j_fn(x_, b_):
        return jops.bias_act(x_, b_, act=act, clamp=clamp)

    want = jax.grad(lambda *a: jnp.sum(j_fn(*a) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(b))
    tx, tb = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    out = tops.bias_act(tx, tb, act=act, clamp=clamp)
    got = torch.autograd.grad((out * _t(g)).sum(), (tx, tb),
                              create_graph=True)
    _close(got[0], want[0])
    _close(got[1], want[1], atol=1e-4, rtol=1e-4)      # a sum over rows

    def j_penalty(x_, b_):
        gx = jax.grad(lambda v: jnp.sum(j_fn(v, b_) * g))(x_)
        return jnp.sum(jnp.square(gx) * (1.0 + g))

    want2 = jax.grad(j_penalty, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(b))
    pen = (got[0].square() * (1.0 + _t(g))).sum()
    if pen.requires_grad:
        got2 = torch.autograd.grad(pen, (tx, tb), allow_unused=True)
        for a, e in zip(got2, want2):
            a = torch.zeros_like(tx if a is None and e.ndim == 3 else tb) \
                if a is None else a
            _close(a, e, atol=1e-4, rtol=1e-4)
    else:       # a piecewise-linear activation: no second derivative
        assert not j_acts[act].has_2nd_grad
        assert float(jnp.abs(want2[0]).max()) == 0.0


@pytest.mark.parametrize("act", ["tanh", "swish", "lrelu", "selu"])
def test_bias_act_gradcheck_f64(act):
    x = _t(_rand((2, 3, 4), seed=18, dtype=np.float64)).requires_grad_(True)
    b = _t(_rand((4,), seed=19, dtype=np.float64)).requires_grad_(True)
    fn = lambda x_, b_: tops.bias_act(x_, b_, act=act, clamp=1.2)
    assert fn(x, b).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x, b))
    assert torch.autograd.gradgradcheck(fn, (x, b))


# ---------------------------------------------------------------------------
# fma, conv2d_resample, grid_sample, resize
# ---------------------------------------------------------------------------

def test_fma_matches_pgx_with_broadcast_gradients():
    a, b, c = _rand((2, 3, 4), 20), _rand((3, 1), 21), _rand((4,), 22)
    _close(tops.fma(_t(a), _t(b), _t(c)),
           jops.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    want = jax.grad(lambda *v: jnp.sum(jnp.square(jops.fma(*v))),
                    argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(c))
    leaves = [_t(v).requires_grad_(True) for v in (a, b, c)]
    got = torch.autograd.grad(tops.fma(*leaves).square().sum(), leaves)
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(), dict(up=2), dict(down=2), dict(up=2, down=2, padding=1),
    dict(padding=(1, 2, 0, 1), flip_weight=False),
    dict(up=2, flip_filter=True, groups=2),
], ids=["plain", "up", "down", "updown", "pad-noflip", "up-groups"])
def test_conv2d_resample_matches_pgx(kw):
    groups = kw.get("groups", 1)
    x = _rand((2, 8, 8, 4), seed=23)
    w = _rand((3, 3, 4 // groups, 6), seed=24) * 0.3
    for f in ([1, 3, 3, 1], WAVELETS["sym2"] * 2):    # 2-D, then separable
        jf, tf = jops.setup_filter(f), tops.setup_filter(f)
        _close(tops.conv2d_resample(_t(x), _t(w), tf, **kw),
               jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), jf,
                                    **kw), atol=1e-4, rtol=1e-4)


def test_grid_sample_and_affine_grid_match_pgx_and_torch():
    rng = np.random.RandomState(25)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    theta = (np.eye(2, 3)[None] + rng.randn(2, 2, 3) * 0.4).astype(
        np.float32)
    for align in (False, True):
        jg = jops.affine_grid(jnp.asarray(theta), (2, 6, 5), align)
        tg = tops.affine_grid(_t(theta), (2, 6, 5), align)
        _close(tg, jg, atol=1e-6)
        _close(tg, F.affine_grid(_t(theta), (2, 3, 6, 5),
                                 align_corners=align).numpy(), atol=1e-6)
    grid = tops.affine_grid(_t(theta), (2, 6, 5))
    want = jops.grid_sample(jnp.asarray(x), jnp.asarray(grid.numpy()))
    tx = _t(x).requires_grad_(True)
    got = tops.grid_sample(tx, grid)
    _close(got, want)
    ref = F.grid_sample(_t(x).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    _close(got, ref.permute(0, 2, 3, 1).numpy())
    ct = rng.randn(*want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jops.grid_sample(v, jnp.asarray(
        grid.numpy())), jnp.asarray(x))
    gx, = torch.autograd.grad(got, tx, _t(ct))
    _close(gx, vjp(jnp.asarray(ct))[0])
    # an f64 image keeps its dtype and the f32 coordinates
    got64 = tops.grid_sample(_t(x.astype(np.float64)), grid)
    assert got64.dtype == torch.float64
    _close(got64, jops.grid_sample(jnp.asarray(x.astype(np.float64)),
                                   jnp.asarray(grid.numpy())), atol=1e-12)


def test_ops_exports_match_pgx():
    import pgx.ops as P
    names = [n for n in vars(P) if not n.startswith("_")
             and callable(getattr(P, n)) or n == "activation_funcs"]
    for n in names:
        assert hasattr(tops, n), n
    x = _rand((2, 4, 6, 3), seed=26)
    _close(tops.avg_pool2x(_t(x)), jops.avg_pool2x(jnp.asarray(x)),
           atol=1e-7)
