"""pgx_torch.eval.kid against pgx.eval.kid on the CPU: every function on the
same inputs and seeds, 1e-12 relative (both are numpy float64 with the same
``RandomState`` subset draws), the full-set single pass, and the end-to-end
KID against pgx's with one random Inception weights file (the two
packages' f32 convolutions differ by ~1e-6 relative: 1e-3 of the value,
pgx's own bound between its JAX and torch stacks)."""

import os

import numpy as np
import pytest
import torch

from pgx.eval import inception as jinc
from pgx.eval import kid as jkid
from pgx.eval.fid import make_extractor as jmake_extractor
from pgx_torch.eval import inception as tinc
from pgx_torch.eval import kid as tkid
from pgx_torch.eval.fid import make_extractor as tmake_extractor

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel test run every worker's torch would take every
    core; one intra-op thread each keeps them from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    assert abs(got - want) <= RTOL * max(abs(want), 1e-300), (got, want)


@pytest.mark.parametrize("kw", [{}, dict(degree=2, gamma=0.3, coef0=0.5)])
def test_polynomial_kernel_equals_pgx(kw):
    rng = np.random.RandomState(0)
    x, y = rng.randn(13, 7), rng.randn(9, 7).astype(np.float32)
    np.testing.assert_allclose(tkid.polynomial_kernel(x, y, **kw),
                               jkid.polynomial_kernel(x, y, **kw),
                               rtol=RTOL, atol=0)


def test_mmd2_unbiased_equals_pgx_and_refuses_one_sample():
    rng = np.random.RandomState(1)
    x, y = rng.randn(6, 4), rng.randn(5, 4)
    ks = (tkid.polynomial_kernel(x, x), tkid.polynomial_kernel(y, y),
          tkid.polynomial_kernel(x, y))
    _close(tkid.mmd2_unbiased(*ks), jkid.mmd2_unbiased(*ks))
    one = np.ones((1, 1))
    with pytest.raises(ValueError):
        tkid.mmd2_unbiased(one, ks[1], ks[2][:1])


@pytest.mark.parametrize("shift,subset,subsets,seed",
                         [(0.0, 100, 40, 0), (1.0, 100, 40, 0),
                          (0.5, 37, 7, 3), (0.5, 1000, 5, 1)])
def test_kid_from_activations_equals_pgx(shift, subset, subsets, seed):
    rng = np.random.RandomState(2)
    real, fake = rng.randn(400, 16), rng.randn(300, 16) + shift
    got = tkid.kid_from_activations(real, fake, subset_size=subset,
                                    num_subsets=subsets, seed=seed)
    want = jkid.kid_from_activations(real, fake, subset_size=subset,
                                     num_subsets=subsets, seed=seed)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_kid_full_set_is_one_pass():
    """When the subset covers both whole sets every draw is a permutation
    and MMD^2 does not depend on the order: one computation, std 0."""
    rng = np.random.RandomState(0)
    real, fake = rng.randn(50, 8), rng.randn(50, 8) + 0.5
    mean, std = tkid.kid_from_activations(real, fake, subset_size=1000,
                                          num_subsets=100)
    assert std == 0.0
    _close(mean, tkid.mmd2_unbiased(tkid.polynomial_kernel(real, real),
                                    tkid.polynomial_kernel(fake, fake),
                                    tkid.polynomial_kernel(real, fake)))
    assert (mean, std) == jkid.kid_from_activations(
        real, fake, subset_size=1000, num_subsets=100)
    with pytest.raises(ValueError):
        tkid.kid_from_activations(real[:1], fake)


def test_kid_given_data_equals_pgx(tmp_path):
    from tests.torch_fid_inception import FIDInceptionV3, randomize_
    model = randomize_(FIDInceptionV3(), seed=2).eval()
    path = os.path.join(str(tmp_path), "rand_inception.pt")
    torch.save(model.state_dict(), path)
    rng = np.random.RandomState(5)
    real = (rng.rand(8, 16, 16, 3) * 255).astype(np.uint8)
    fake = rng.randn(8, 16, 16, 3).astype(np.float32)
    kw = dict(batch_size=4, subset_size=6, num_subsets=3, seed=1)
    want = jkid.calculate_kid_given_data(
        real, fake, jmake_extractor(jinc.load_torch_weights(path)), **kw)
    got = tkid.calculate_kid_given_data(
        real, fake, tmake_extractor(tinc.load_torch_weights(path),
                                    device="cpu"), **kw)
    assert np.isfinite(got[0]) and got[1] >= 0
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * max(abs(w), 1e-3), (got, want)
