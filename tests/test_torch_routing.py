"""Which path the layers take for a shape, on the CPU.

Kernels A, B and C take float32 or bfloat16 with C a multiple of 8 and at
most 512 (C also C_in a multiple of 8 and a 3x3 kernel); each module's
``supported`` says so, and the layers ask it before calling the kernel, as
pgx asks its own ``supported()``.  Elsewhere the conv is cuDNN's and the
epilogue the plain torch ops.  On the CPU a wrapper takes its plain
version for any shape, so these tests replace the wrappers with guards
that raise on a shape the predicate refuses: a forward that passes shows
the route, and its output is held against pgx's (atol/rtol 1e-4 in f32, as
the model parity tests hold theirs).  Kernel D takes 1 to 64 taps: a longer
1-D filter takes the grouped-conv branch.  A wrapper copies a view whose
pointer is not 16-byte aligned (``build.aligned``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from pgx.models import config as jcfg
from pgx.models import zoo as jzoo
from pgx.models.discriminator import discriminator_apply as jd_apply
from pgx.models.discriminator import init_discriminator as jd_init
from pgx.models.generator import generator_apply as jg_apply
from pgx.models.generator import init_generator as jg_init
from pgx_torch.core import layers as TL
from pgx_torch.models import config as tcfg
from pgx_torch.models import generator as TG
from pgx_torch.models import zoo as tzoo
from pgx_torch.models.discriminator import Discriminator
from pgx_torch.models.generator import Generator
from pgx_torch.ops.kernels import build, conv_epilogue, epilogue

# the packages export functions of these names: take the modules
kernel_b = importlib.import_module("pgx_torch.ops.kernels.pixel_norm_lrelu")
ops_upfirdn2d = importlib.import_module("pgx_torch.ops.upfirdn2d")
j_upfirdn2d = importlib.import_module("pgx.ops.upfirdn2d")

TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = [torch.bfloat16, torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 4, 12, 512, 520])
def test_predicates_at_the_boundaries(c, dtype):
    want = dtype != torch.float64 and c % 8 == 0 and c <= 512
    y = torch.zeros(2, 3, 3, c, dtype=dtype)
    assert epilogue.supported(y) is want
    assert kernel_b.supported(y) is want
    # kernel C: C_in and C_out both c, then each alone
    w = torch.zeros(3, 3, c, c)
    assert conv_epilogue.supported(y, w) is want
    x8 = torch.zeros(2, 3, 3, 8, dtype=dtype)
    assert conv_epilogue.supported(x8, torch.zeros(3, 3, 8, c)) is want
    assert conv_epilogue.supported(y, torch.zeros(3, 3, c, 8)) is (
        dtype != torch.float64 and c % 8 == 0)


def test_conv_predicate_needs_a_matching_3x3_kernel():
    x = torch.zeros(1, 4, 4, 16)
    assert conv_epilogue.supported(x, torch.zeros(3, 3, 16, 32))
    assert not conv_epilogue.supported(x, torch.zeros(1, 1, 16, 32))
    assert not conv_epilogue.supported(x, torch.zeros(3, 3, 24, 32))
    assert not conv_epilogue.supported(x[0], torch.zeros(3, 3, 16, 32))


@pytest.fixture
def guarded(monkeypatch):
    """The kernel wrappers where the layers call them, replaced by guards
    that raise on a shape their predicate refuses and count the calls."""
    calls = {"A": 0, "B": 0, "C": 0}

    def guard(name, fn, ok):
        def wrapped(*args, **kw):
            if not ok(*args):
                raise AssertionError(f"kernel {name} handed {args[0].shape}")
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(TL, "bias_pixelnorm_lrelu", guard(
        "A", TL.bias_pixelnorm_lrelu, lambda y, *a: epilogue.supported(y)))
    monkeypatch.setattr(TL, "conv3x3_epilogue", guard(
        "C", TL.conv3x3_epilogue,
        lambda x, w, *a: conv_epilogue.supported(x, w)))
    monkeypatch.setattr(TG, "pixel_norm_lrelu", guard(
        "B", TG.pixel_norm_lrelu, lambda x, *a: kernel_b.supported(x)))
    return calls


def _raise(*args, **kw):
    raise AssertionError("the separable kernel path was taken")


def test_layers_take_torch_ops_for_an_unsupported_width(guarded):
    """C = 4: the epilogue is pixel_norm -> leaky_relu; a 3x3 conv with C_in
    or C_out outside the rule is cuDNN's, followed by kernel A where its
    output width is one A takes."""
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.randn(2, 5, 5, 4).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    torch.testing.assert_close(TL.conv_epilogue(y, b, True),
                               TL.leaky_relu(TL.pixel_norm(y + b), 0.2),
                               atol=0, rtol=0)
    assert guarded == {"A": 0, "B": 0, "C": 0}
    for cin, cout, a_calls in ((4, 8, 1), (8, 4, 0), (12, 16, 1)):
        conv = TL.EqualConv2d(cin, cout, 3)
        with torch.no_grad():
            conv.w.copy_(torch.from_numpy(
                rng.randn(3, 3, cin, cout).astype(np.float32)))
            conv.b.copy_(torch.from_numpy(rng.randn(cout).astype(
                np.float32)))
        x = torch.from_numpy(rng.randn(2, 6, 6, cin).astype(np.float32))
        before = dict(guarded)
        got = TL._conv_step(conv, x, 1, True, 0.2)
        assert guarded["C"] == before["C"]
        assert guarded["A"] == before["A"] + a_calls
        yy = TL.equal_conv2d(conv.w, conv.b, x, padding=1, bias=False)
        want = TL.leaky_relu(TL.pixel_norm(yy + conv.b), 0.2)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_layers_take_the_kernels_for_a_supported_width(guarded):
    rng = np.random.RandomState(1)
    y = torch.from_numpy(rng.randn(2, 5, 5, 8).astype(np.float32))
    TL.conv_epilogue(y, torch.zeros(8), True)
    conv = TL.EqualConv2d(8, 16, 3)
    TL._conv_step(conv, y, 1, True, 0.2)
    TL._conv_step(conv, y, 1, True, 0.2, fused=False)
    assert guarded == {"A": 1 + 1, "B": 0, "C": 1}
    # f64 is not a kernel dtype: the torch ops
    TL.conv_epilogue(y.double(), torch.zeros(8, dtype=torch.float64), True)
    assert guarded["A"] == 2


G_CASES = {
    # widths 16, 16, 16, 16, 8, 4, 4: C at 4 channels from step 5 on
    "legacy_generator": (jzoo.legacy_generator, tzoo.legacy_generator,
                         dict(z_dim=8, channel=16, max_step=6), (5,)),
    # four channels everywhere, kernel B's input layer included
    "mnist_generator": (jzoo.mnist_generator, tzoo.mnist_generator,
                        dict(z_dim=8, channel=4), (3,)),
}


@pytest.mark.parametrize("name", list(G_CASES))
def test_small_width_generators_match_pgx(guarded, name):
    jfac, tfac, kw, steps = G_CASES[name]
    assert tfac(**kw).__dict__ == jfac(**kw).__dict__
    jc = jcfg.GeneratorConfig(**jfac(**kw).__dict__)
    params = jax.device_get(jg_init(jax.random.PRNGKey(0), jc))
    gen = Generator.from_jax_params(tfac(**kw), params, "cpu")
    z = np.random.RandomState(2).randn(2, jc.z_dim).astype(np.float32)
    for step in steps:
        want = np.asarray(jax.jit(lambda p, z_, s=step: jg_apply(
            p, jc, z_, None, step=s))(params, z))
        with torch.no_grad():
            got = gen(torch.from_numpy(z), step=step)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
    # the supported widths still went through the kernels
    if name == "legacy_generator":
        assert guarded["B"] > 0 and guarded["C"] > 0
    else:
        assert guarded == {"A": 0, "B": 0, "C": 0}


def test_small_width_discriminator_matches_pgx(guarded):
    """legacy_discriminator(feat_dim=16): widths 8 and 4 from step 5 on;
    kernel A only where C is a multiple of 8."""
    kw = dict(feat_dim=16, max_step=6)
    assert (tzoo.legacy_discriminator(**kw).__dict__
            == jzoo.legacy_discriminator(**kw).__dict__)
    jc = jcfg.DiscriminatorConfig(**jzoo.legacy_discriminator(**kw).__dict__)
    params = jax.device_get(jd_init(jax.random.PRNGKey(1), jc))
    disc = Discriminator.from_jax_params(tzoo.legacy_discriminator(**kw),
                                         params, "cpu")
    rng = np.random.RandomState(3)
    for step in (6,):
        res = 4 * 2 ** jc.entry_stage(step)
        img = rng.randn(2, res, res, 3).astype(np.float32)
        want = np.asarray(jax.jit(lambda p, x, s=step: jd_apply(
            p, jc, x, None, step=s))(params, img))
        with torch.no_grad():
            got = disc(torch.from_numpy(img), None, step=step)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert guarded["A"] > 0 and guarded["C"] == 0


@pytest.mark.parametrize("ntaps", [65, 101])
@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_long_filters_take_the_grouped_conv(monkeypatch, ntaps, up, down):
    rng = np.random.RandomState(ntaps + 10 * up + down)
    x = rng.randn(1, 9, 11, 2).astype(np.float32)
    f = (rng.rand(ntaps) / ntaps).astype(np.float32)
    pad = (ntaps // 2, ntaps // 2 - 1, ntaps // 2 + 1, ntaps // 2)
    want = np.asarray(j_upfirdn2d.upfirdn2d(x, f, up=up, down=down,
                                            padding=pad))
    monkeypatch.setattr(ops_upfirdn2d, "upfirdn2d_separable", _raise)
    got = ops_upfirdn2d.upfirdn2d(torch.from_numpy(x), f, up=up,
                                  down=down, padding=pad)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_aligned_copies_a_misaligned_view_only():
    x = torch.randn(2, 127, 127, 3).to(torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert build.aligned(x) is x
    view = x[1:]
    assert view.data_ptr() % 16 == 127 * 127 * 3 * 2 % 16 != 0
    got = build.aligned(view)
    assert got is not view and got.data_ptr() % 16 == 0
    assert got.is_contiguous() and got.dtype == view.dtype
    torch.testing.assert_close(got, view, atol=0, rtol=0)
    # layout is left to the input check: an aligned permuted view stays
    perm = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)
    assert build.aligned(perm) is perm
