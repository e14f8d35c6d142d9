"""Kernel A's second derivative as its own Function, on the CPU in f64.

``_BiasPixelNormLreluGrad`` (A's backward) has ``_BiasPixelNormLreluGrad2``
as its backward: its forward launches the second-order kernel on a card and
runs the plain closed form (``second_order_ref``) on the CPU; its backward
differentiates the plain closed form again.  Held here against autograd
through the plain first-order backward (``rownorm_lrelu_backward`` with the
``db`` row sum) to 1e-10, for cotangents on dy only, db only and both, and
for every pattern of inputs that need a gradient; its own backward against
finite differences (``gradcheck``, third order of A); and the chain inside a
gradient penalty: the kernels' Functions against the same network written
in plain torch ops, to 1e-10.
"""

import itertools

import numpy as np
import pytest
import torch

from pgx_torch.core import layers as TL
from pgx_torch.ops import kernels as K
from pgx_torch.ops.kernels import epilogue as E

SHAPE = (2, 3, 3, 8)


def _f64(shape, seed, scale=1.0, grad=True):
    t = torch.from_numpy(np.random.RandomState(seed).randn(*shape) * scale)
    return t.requires_grad_(grad)


def _inputs(need_y=True, need_b=True, need_g=True):
    y = _f64(SHAPE, 1, grad=False)
    y.view(-1)[::7] = 0.0          # rows of both signs, a few exact zeros
    return (y.requires_grad_(need_y), _f64(SHAPE[-1:], 2, 0.3, need_b),
            _f64(SHAPE, 3, grad=need_g))


def _plain_first_order(y, b, g, slope=0.2, eps=1e-8):
    da = E.rownorm_lrelu_backward(y + b, g, slope, eps)
    return da, da.reshape(-1, da.shape[-1]).sum(0)


NEEDS = [n for n in itertools.product((False, True), repeat=3) if any(n)]
COTANGENTS = ["ddy", "ddb", "both"]


@pytest.mark.parametrize("which", COTANGENTS)
@pytest.mark.parametrize("needs", NEEDS)
def test_forward_matches_autograd_of_plain_backward(needs, which):
    y, b, g = _inputs()
    ddy = _f64(SHAPE, 4, grad=False) if which != "ddb" else None
    ddb = _f64(SHAPE[-1:], 5, grad=False) if which != "ddy" else None
    got = E._BiasPixelNormLreluGrad2.apply(y.detach(), b.detach(),
                                           g.detach(), ddy, ddb, 0.2, 1e-8,
                                           needs)
    pairs = [(o, c) for o, c in zip(_plain_first_order(y, b, g), (ddy, ddb))
             if c is not None]
    want = torch.autograd.grad([o for o, _ in pairs], (y, b, g),
                               [c for _, c in pairs])
    for name, need, x, w in zip(("d_y", "d_b", "d_g"), needs, got, want):
        if not need:
            assert x is None, name
            continue
        assert x.dtype == torch.float64 and x.shape == w.shape, name
        torch.testing.assert_close(x, w, atol=1e-10, rtol=0, msg=name)


@pytest.mark.parametrize("need_y,need_b,need_g", NEEDS)
def test_backward_of_backward_follows_needs_input_grad(need_y, need_b,
                                                       need_g):
    """Through autograd: A's backward Function asks its backward for the
    inputs that need a gradient only, and gets the plain values."""
    y, b, g = _inputs(need_y, need_b, need_g)
    dy, db = E._BiasPixelNormLreluGrad.apply(y, b, g, 0.2, 1e-8)
    ddy, ddb = _f64(SHAPE, 6, grad=False), _f64(SHAPE[-1:], 7, grad=False)
    wrt = [t for t in (y, b, g) if t.requires_grad]
    got = torch.autograd.grad((dy, db), wrt, (ddy, ddb))
    y2, b2, g2 = (t.detach().requires_grad_(True) for t in (y, b, g))
    want = torch.autograd.grad(_plain_first_order(y2, b2, g2),
                               [t2 for t, t2 in zip((y, b, g), (y2, b2, g2))
                                if t.requires_grad], (ddy, ddb))
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-10, rtol=0)


def test_gradcheck_third_order():
    """The Function's backward (A's third derivative) against finite
    differences, with cotangents on every output."""
    y, b, g = _inputs()
    ddy, ddb = _f64(SHAPE, 8), _f64(SHAPE[-1:], 9)
    assert torch.autograd.gradcheck(
        lambda *t: E._BiasPixelNormLreluGrad2.apply(*t, 0.2, 1e-8,
                                                    (True, True, True)),
        (y, b, g, ddy, ddb))


def _penalty_grads(epilogue):
    """A two-conv network under the WGAN-GP penalty in f64: the gradient of
    the score with respect to the input, created as a graph, its norm
    penalty differentiated with respect to every parameter."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 5, 5, 8)).requires_grad_(True)
    params = [torch.from_numpy(rng.randn(*s) * sc).requires_grad_(True)
              for s, sc in (((3, 3, 8, 16), 0.2), ((16,), 0.3),
                            ((3, 3, 16, 8), 0.2), ((8,), 0.3))]
    w1, b1, w2, b2 = params
    h = epilogue(TL.equal_conv2d(w1, b1, x, padding=1, bias=False), b1)
    h = epilogue(TL.equal_conv2d(w2, b2, h, padding=1, bias=False), b2)
    score = (h * h).sum(dim=(1, 2, 3))
    gx, = torch.autograd.grad(score.sum(), x, create_graph=True)
    pen = ((gx.square().sum(dim=(1, 2, 3)).sqrt() - 1.0) ** 2).mean()
    return torch.autograd.grad(pen, params)


def test_penalty_through_the_kernel_functions_matches_plain_ops(
        monkeypatch):
    calls = []
    inner = E.second_order_ref

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(E, "second_order_ref", spy)
    got = _penalty_grads(lambda y, b: K.bias_pixelnorm_lrelu(y, b, 0.2))
    monkeypatch.undo()
    # the outer pass ran the second derivative for both epilogues
    assert len(calls) == 2
    want = _penalty_grads(lambda y, b: TL.leaky_relu(TL.pixel_norm(y + b),
                                                     0.2))
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-10, rtol=1e-10)
