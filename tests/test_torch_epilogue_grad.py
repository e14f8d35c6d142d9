"""Kernel A's backward Function and its closed-form second derivative, on
the CPU in f64.

``bias_pixelnorm_lrelu``'s backward is ``_BiasPixelNormLreluGrad``: its
forward is the backward kernel (on the CPU its plain version), its backward
the second derivative written out in closed form
(``rownorm_lrelu_backward_vjp``).  Held here against autograd of the plain
first-order backward (``rownorm_lrelu_backward``) to 1e-10, and against
finite differences (``gradcheck`` / ``gradgradcheck``), with cotangents on
both outputs, dy and db.  The comparisons with pgx's ``jax.grad`` (first
and second order) are in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from pgx_torch.ops import kernels as K
from pgx_torch.ops.kernels import epilogue as E


def _f64(shape, seed, scale=1.0, grad=True):
    t = torch.from_numpy(np.random.RandomState(seed).randn(*shape) * scale)
    return t.requires_grad_(grad)


def _signed_rows(shape, seed):
    """Rows whose entries take both signs, a few exactly at 0."""
    a = _f64(shape, seed, grad=False)
    a.view(-1)[::7] = 0.0
    return a.requires_grad_(True)


@pytest.mark.parametrize("slope", [0.2, 1.0])
@pytest.mark.parametrize("eps", [1e-8, 0.5])
def test_closed_form_matches_autograd_of_plain_backward(slope, eps):
    a = _signed_rows((3, 2, 5, 16), 1)
    g = _f64((3, 2, 5, 16), 2)
    u = _f64((3, 2, 5, 16), 3, grad=False)
    assert bool((a < 0).any()) and bool((a > 0).any())
    da = E.rownorm_lrelu_backward(a, g, slope, eps)
    want_a, want_g = torch.autograd.grad(da, (a, g), u)
    got_a, got_g = E.rownorm_lrelu_backward_vjp(a.detach(), g.detach(), u,
                                                slope, eps)
    assert got_a.dtype == got_g.dtype == torch.float64
    torch.testing.assert_close(got_a, want_a, atol=1e-10, rtol=0)
    torch.testing.assert_close(got_g, want_g, atol=1e-10, rtol=0)


@pytest.mark.parametrize("slope", [0.2, 1.0])
def test_grad_function_backward_matches_autograd_of_plain(slope):
    """The Function's own backward, with cotangents on dy and on db (the
    same da, summed over rows), against autograd of the plain version."""
    y, b, g = _signed_rows((2, 3, 3, 8), 4), _f64((8,), 5, 0.3), _f64(
        (2, 3, 3, 8), 6)
    ddy, ddb = _f64((2, 3, 3, 8), 7, grad=False), _f64((8,), 8, grad=False)
    got = torch.autograd.grad(
        E._BiasPixelNormLreluGrad.apply(y, b, g, slope, 1e-8), (y, b, g),
        (ddy, ddb))
    want = torch.autograd.grad(
        E.bias_pixelnorm_lrelu_backward_ref(y, b, g, slope, 1e-8), (y, b, g),
        (ddy, ddb))
    for name, x, w in zip("ybg", got, want):
        torch.testing.assert_close(x, w, atol=1e-10, rtol=0, msg=name)
    # a cotangent on one output only
    got_y, = torch.autograd.grad(
        E._BiasPixelNormLreluGrad.apply(y, b, g, slope, 1e-8)[1], y, ddb)
    want_y, = torch.autograd.grad(
        E.bias_pixelnorm_lrelu_backward_ref(y, b, g, slope, 1e-8)[1], y, ddb)
    torch.testing.assert_close(got_y, want_y, atol=1e-10, rtol=0)


def test_gradcheck_f64_first_and_second_order():
    """Finite differences through both Functions, cotangents on dy and db
    (gradgradcheck draws one for every first-order output)."""
    y, b = _f64((2, 2, 3, 8), 1), _f64((8,), 2, 0.3)
    f = lambda y_, b_: K.bias_pixelnorm_lrelu(y_, b_, 0.2)
    assert torch.autograd.gradcheck(f, (y, b))
    assert torch.autograd.gradgradcheck(f, (y, b))
    g = _f64((2, 2, 3, 8), 3)
    grad_fn = lambda y_, b_, g_: E._BiasPixelNormLreluGrad.apply(
        y_, b_, g_, 0.2, 1e-8)
    assert torch.autograd.gradcheck(grad_fn, (y, b, g))


def test_backward_records_the_grad_function():
    """Under create_graph=True the first-order backward is one node of
    the Grad Function, not the plain ops; on the CPU nothing counts as a
    launch."""
    y, b = _f64((1, 2, 2, 8), 9), _f64((8,), 10, 0.3)
    before = K.launch_counts()
    gy, gb = torch.autograd.grad(K.bias_pixelnorm_lrelu(y, b).sum(), (y, b),
                                 create_graph=True)
    assert type(gy.grad_fn).__name__ == "_BiasPixelNormLreluGradBackward"
    assert gb.grad_fn is gy.grad_fn
    assert K.launch_counts() == before
    want = E.bias_pixelnorm_lrelu_backward_ref(
        y.detach(), b.detach(), torch.ones(1, 2, 2, 8, dtype=torch.float64))
    torch.testing.assert_close(gy.detach(), want[0], atol=1e-14, rtol=0)
    torch.testing.assert_close(gb.detach(), want[1], atol=1e-14, rtol=0)
