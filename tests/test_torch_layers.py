"""pgx_torch.core.layers / pgx_torch.ops.resize against pgx on the CPU.

Same numpy inputs and weights through both packages, f32 (pgx at
``highest`` matmul precision, set by tests/conftest.py).  Tolerance: atol
and rtol 1e-5 — f32 arithmetic in another order, outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pgx.core import layers as JL
from pgx.ops.resize import upsample2x as j_upsample2x
from pgx_torch.core import layers as TL
from pgx_torch.ops.resize import UP_FIR
from pgx_torch.ops.resize import upsample2x as t_upsample2x

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _conv(in_ch, out_ch, k, seed):
    return {"w": _rand((k, k, in_ch, out_ch), seed),
            "b": _rand((out_ch,), seed + 100, 0.1)}


def _module(mod, tree):
    """Load a numpy params dict into a port module by pgx key names."""
    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{pre}{k}.") if isinstance(v, dict)
                       else {pre + k: torch.from_numpy(v)})
        return out
    mod.load_state_dict(flat(tree), strict=True)
    return mod


def _jp(tree):
    return {k: (_jp(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 5, 7, 8)])
def test_upsample2x_matches(shape):
    x = _rand(shape, 0)
    want = np.asarray(j_upsample2x(jnp.asarray(x)))
    got = t_upsample2x(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the reference's bilinear resize
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_upsample2x_is_the_up_fir_interleave():
    """Edge pad + the interleaved 2-tap phases of UP_FIR, along H then W,
    written out tap by tap (pgx's formulation) in float64."""
    x = torch.from_numpy(_rand((2, 3, 5, 4), 1)).double()

    def axis_h(v):
        p = torch.cat([v[:, :1], v, v[:, -1:]], dim=1)
        even = UP_FIR[0] * p[:, :-2] + UP_FIR[1] * p[:, 1:-1]
        odd = UP_FIR[2] * p[:, 1:-1] + UP_FIR[3] * p[:, 2:]
        b, h, w, c = even.shape
        return torch.stack([even, odd], dim=2).reshape(b, 2 * h, w, c)

    want = axis_h(axis_h(x).transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(t_upsample2x(x), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape,cout,bias", [((2, 4, 4, 8), 16, True),
                                             ((1, 6, 5, 16), 8, False)])
def test_equal_conv2d_up2x_matches_including_border(shape, cout, bias):
    p = _conv(shape[-1], cout, 3, 1)
    x = _rand(shape, 2)
    want = np.asarray(JL.equal_conv2d_up2x(_jp(p), jnp.asarray(x),
                                           bias=bias))
    got = TL.equal_conv2d_up2x(torch.from_numpy(p["w"]),
                               torch.from_numpy(p["b"]),
                               torch.from_numpy(x), bias=bias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the border rows/columns are where pgx's fused form is corrected
    for edge in (got.numpy()[:, 0], got.numpy()[:, -1],
                 got.numpy()[:, :, 0], got.numpy()[:, :, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got.numpy()[:, [0, -1]], want[:, [0, -1]],
                               **TOL)
    np.testing.assert_allclose(got.numpy()[:, :, [0, -1]],
                               want[:, :, [0, -1]], **TOL)


@pytest.mark.parametrize("padding", [0, 1])
def test_equal_conv2d_matches(padding):
    p = _conv(8, 4, 3, 3)
    x = _rand((2, 6, 6, 8), 4)
    want = np.asarray(JL.equal_conv2d(_jp(p), jnp.asarray(x),
                                      padding=padding))
    got = TL.equal_conv2d(torch.from_numpy(p["w"]), torch.from_numpy(p["b"]),
                          torch.from_numpy(x), padding=padding)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_latent_to_4x4_matches():
    p = {"w": _rand((4, 4, 16, 24), 5), "b": _rand((16,), 6, 0.1)}
    z = _rand((3, 24), 7)
    want = np.asarray(JL.latent_to_4x4(_jp(p), jnp.asarray(z)))
    got = TL.latent_to_4x4(torch.from_numpy(p["w"]), torch.from_numpy(p["b"]),
                           torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("equalized", [False, True])
def test_embedding_matches(equalized):
    w = _rand((10, 12), 8)
    labels = np.array([0, 3, 9, 3], np.int32)
    want = np.asarray(JL.embedding({"w": jnp.asarray(w)},
                                   jnp.asarray(labels), equalized=equalized))
    got = TL.embedding(torch.from_numpy(w), torch.from_numpy(labels),
                       equalized=equalized)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pixel_norm_and_leaky_relu_match():
    x = _rand((2, 3, 3, 16), 9)
    np.testing.assert_allclose(TL.pixel_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.pixel_norm(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(
        TL.leaky_relu(torch.from_numpy(x), 0.1).numpy(),
        np.asarray(JL.leaky_relu(jnp.asarray(x), 0.1)), **TOL)


@pytest.mark.parametrize("pn,upsample_first,shape", [
    (True, False, (2, 8, 8, 16)), (False, False, (2, 4, 4, 16)),
    (True, True, (2, 4, 4, 16)), (False, True, (1, 4, 4, 16))])
def test_conv_block_matches(pn, upsample_first, shape):
    p = {"conv1": _conv(16, 8, 3, 10), "conv2": _conv(8, 8, 3, 11)}
    x = _rand(shape, 12)
    want = np.asarray(JL.conv_block(_jp(p), jnp.asarray(x),
                                    use_pixel_norm=pn,
                                    upsample_first=upsample_first))
    blk = _module(TL.ConvBlock(16, 8), p)
    with torch.no_grad():
        got = TL.conv_block(blk, torch.from_numpy(x), use_pixel_norm=pn,
                            upsample_first=upsample_first)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pn,upsample_first,slope", [
    (True, False, 0.2), (False, False, 0.1), (True, True, 0.2)])
def test_single_conv_block_matches(pn, upsample_first, slope):
    p = {"conv1": _conv(8, 16, 3, 13)}
    x = _rand((2, 4, 4, 8), 14)
    want = np.asarray(JL.single_conv_block(
        _jp(p), jnp.asarray(x), use_pixel_norm=pn, slope=slope,
        upsample_first=upsample_first))
    blk = _module(TL.SingleConvBlock(8, 16), p)
    with torch.no_grad():
        got = TL.single_conv_block(blk, torch.from_numpy(x),
                                   use_pixel_norm=pn, slope=slope,
                                   upsample_first=upsample_first)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("groups,shape", [(1, (4, 4, 4, 8)),
                                          (3, (6, 4, 4, 8)),
                                          (2, (4, 2, 2, 16))])
def test_minibatch_stddev_matches(groups, shape):
    x = _rand(shape, 20)
    want = np.asarray(JL.minibatch_stddev(jnp.asarray(x), groups=groups))
    got = TL.minibatch_stddev(torch.from_numpy(x), groups=groups)
    assert got.shape == shape[:3] + (shape[3] + 1,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if groups > 1:      # each slice scores as a separate call would
        n = shape[0] // groups
        parts = torch.cat([TL.minibatch_stddev(torch.from_numpy(x[i:i + n]))
                           for i in range(0, shape[0], n)])
        np.testing.assert_allclose(got.numpy(), parts.numpy(), **TOL)


def test_minibatch_stddev_is_the_biased_variance_and_checks_groups():
    x = _rand((4, 2, 2, 3), 21)
    want = np.sqrt(x.var(axis=0) + 1e-8).mean()       # numpy: ddof = 0
    got = TL.minibatch_stddev(torch.from_numpy(x))[..., -1]
    np.testing.assert_allclose(got.numpy(), np.full((4, 2, 2), want), **TOL)
    with pytest.raises(ValueError, match="divisible"):
        TL.minibatch_stddev(torch.from_numpy(x), groups=3)


def test_equal_linear_matches():
    p = {"w": _rand((24, 5), 22), "b": _rand((5,), 23, 0.1)}
    x = _rand((3, 24), 24)
    want = np.asarray(JL.equal_linear(_jp(p), jnp.asarray(x)))
    lin = _module(TL.EqualLinear(24, 5), p)
    got = TL.equal_linear(lin.w, lin.b, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (1, 8, 6, 5)])
def test_downsample2x_matches(shape):
    from pgx.ops.resize import downsample2x as j_downsample2x
    from pgx_torch.ops.resize import downsample2x as t_downsample2x
    x = _rand(shape, 25)
    want = np.asarray(j_downsample2x(jnp.asarray(x)))
    got = t_downsample2x(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=0.5,
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert t_downsample2x(torch.from_numpy(x).bfloat16()).dtype \
        == torch.bfloat16


def test_downsample2x_refuses_odd_sizes():
    from pgx_torch.ops.resize import downsample2x as t_downsample2x
    with pytest.raises(ValueError, match="even"):
        t_downsample2x(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError, match="even"):
        t_downsample2x(torch.zeros(1, 4, 7, 3))


@pytest.mark.parametrize("padding2", [1, 0])
def test_conv_block_unfused_equals_fused_on_cpu(padding2):
    """``fused=False`` (the discriminator's form: conv, then kernel A) and
    ``fused=True`` (kernel C) compute the same block; on the CPU both take
    plain versions.  With grad, both give the same gradients, and only the
    unfused form differentiates twice."""
    p = {"conv1": _conv(16, 8, 3, 26), "conv2": _conv(8, 8, 3, 27)}
    blk = _module(TL.ConvBlock(16, 8), p)
    x = torch.from_numpy(_rand((2, 6, 6, 16), 28)).requires_grad_(True)
    outs, grads = [], []
    for fused in (True, False):
        y = TL.conv_block(blk, x, padding2=padding2, fused=fused)
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y.square().sum(),
                                         [x, *blk.parameters()]))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **TOL)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)
    y = TL.conv_block(blk, x, padding2=padding2, fused=False)
    gx, = torch.autograd.grad(y.sum(), x, create_graph=True)
    gw, = torch.autograd.grad(gx.square().sum(), blk.conv1.w)
    assert torch.isfinite(gw).all() and float(gw.abs().max()) > 0
    y = TL.conv_block(blk, x, padding2=padding2, fused=True)
    with pytest.raises(RuntimeError, match="differentiable once only"):
        torch.autograd.grad(y.sum(), x, create_graph=True)


@pytest.mark.parametrize("padding,k", [(1, 3), (0, 4), (0, 1)])
def test_conv2d_gradfix_matches_native_conv_to_second_order(padding, k):
    """The conv whose backward is written in forward ops: same values and
    first derivatives as ``F.conv2d``, the same gradient-penalty-shaped
    second derivatives, and finite differences agree in f64."""
    from pgx_torch.ops.conv2d_gradfix import conv2d
    F = torch.nn.functional
    rng = np.random.RandomState(30)
    x = torch.from_numpy(rng.randn(2, 3, 5, 5)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(4, 3, k, k)).requires_grad_(True)
    ours = lambda x_, w_: conv2d(x_, w_, padding)
    native = lambda x_, w_: F.conv2d(x_, w_, padding=padding)
    torch.testing.assert_close(ours(x, w), native(x, w), rtol=1e-12,
                               atol=1e-12)
    with torch.no_grad():
        assert not ours(x, w).requires_grad
    assert torch.autograd.gradcheck(ours, (x, w))
    assert torch.autograd.gradgradcheck(ours, (x, w))

    def penalty_grads(conv):
        gx, = torch.autograd.grad((conv(x, w) ** 3).sum(), x,
                                  create_graph=True)
        return torch.autograd.grad(gx.square().sum(), (x, w))

    for a, b in zip(penalty_grads(ours), penalty_grads(native)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
