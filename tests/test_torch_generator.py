"""pgx_torch's generator against pgx.generator_apply on the CPU.

pgx's own initial params (``jax.device_get(init_generator(...))``) are
carried over with ``Generator.from_jax_params``; z and labels are numpy
draws fed to both.  f32, every step, fading off and on with alpha in
{0, 0.3, 1}.  Tolerance: atol/rtol 1e-4 — a chain of up to a dozen f32
convs and norms summed in another order.
"""

import os
import sys
import subprocess

import numpy as np
import pytest
import torch

import jax

from pgx.models import config as jcfg
from pgx.models import zoo as jzoo
from pgx.models.generator import generator_apply as j_apply
from pgx.models.generator import init_generator as j_init
from pgx_torch.models import config as tcfg
from pgx_torch.models import zoo as tzoo
from pgx_torch.models.generator import Generator, init_generator

TOL = dict(atol=1e-4, rtol=1e-4)

# name -> GeneratorConfig kwargs shared by both packages
CONFIGS = {
    # the flagship family, tiny; fused upsample+conv from 8px inputs on
    "cond_proper": dict(jzoo.conditional_correct_generator(
        z_dim=16, num_classes=5, channel=16, max_step=4).__dict__,
        fuse_up_conv_min_size=8),
    # norm_concat conditioning, proper arch with tanh (step==2 quirk)
    "norm_concat_tanh": dict(jzoo.conditional_correct_generator_ada(
        z_dim=8, num_classes=3, channel=8, max_step=3, tanh=True).__dict__),
    # legacy single-conv blocks, LeakyReLU(0.1) input, grayscale
    "mnist": dict(jzoo.mnist_generator(z_dim=8, channel=8).__dict__),
    # legacy double blocks without pixel norm
    "legacy_no_pn": dict(jzoo.legacy_generator(
        z_dim=8, channel=16, max_step=3, pixel_norm=False).__dict__),
}
CASES = [(name, step) for name, kw in CONFIGS.items()
         for step in range(1, kw["max_step"] + 1)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in CONFIGS.items():
        jc = jcfg.GeneratorConfig(**kw)
        params = jax.device_get(j_init(jax.random.PRNGKey(0), jc))
        tc = tcfg.GeneratorConfig(**kw)
        out[name] = (jc, params, Generator.from_jax_params(tc, params,
                                                           "cpu"))
    return out


@pytest.mark.parametrize("name,step", CASES)
def test_generator_matches_pgx(models, name, step):
    jc, params, gen = models[name]
    rng = np.random.RandomState(step)
    z = rng.randn(3, jc.z_dim).astype(np.float32)
    labels = (rng.randint(0, jc.num_classes, 3).astype(np.int32)
              if jc.conditioning != "none" else None)
    t_lab = torch.from_numpy(labels) if labels is not None else None
    for fading, alpha in [(False, 1.0), (True, 0.0), (True, 0.3),
                          (True, 1.0)]:
        want = np.asarray(j_apply(params, jc, z, labels, step=step,
                                  alpha=alpha, fading=fading))
        with torch.no_grad():
            got = gen(torch.from_numpy(z), t_lab, step=step, alpha=alpha,
                      fading=fading)
        assert got.shape == want.shape == (3, jc.resolution(step),
                                           jc.resolution(step),
                                           jc.img_channels)
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(
            (name, step, fading, alpha)), **TOL)


def test_step2_tanh_quirk_skips_the_blend(models):
    _, _, gen = models["norm_concat_tanh"]
    z = torch.from_numpy(np.random.RandomState(0).randn(2, 8).astype(
        np.float32))
    lab = torch.tensor([0, 2])
    with torch.no_grad():
        a = gen(z, lab, step=2, alpha=0.0, fading=True)
        b = gen(z, lab, step=2, alpha=1.0, fading=False)
        c = gen(z, lab, step=3, alpha=0.0, fading=True)
        d = gen(z, lab, step=3, alpha=1.0, fading=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(c, d)


def test_step_is_clamped_to_max_step(models):
    jc, _, gen = models["mnist"]
    z = torch.zeros(1, jc.z_dim)
    with torch.no_grad():
        assert gen(z, step=9).shape == gen(z, step=jc.max_step).shape


def test_from_jax_params_keeps_f64_and_trainable_flag():
    """An f64 tree stays f64 (a train state carried across for an f64
    parity test); serving keeps the parameters frozen, training asks for
    trainable ones."""
    kw = dict(CONFIGS["cond_proper"], dtype="float64")
    cfg = tcfg.GeneratorConfig(**kw)
    tree = init_generator(cfg, seed=0)
    f64 = lambda t: {k: (f64(v) if isinstance(v, dict)
                         else v.astype(np.float64) + 1e-12)
                     for k, v in t.items()}
    tree64 = f64(tree)
    gen = Generator.from_jax_params(cfg, tree64, "cpu", trainable=True)
    assert all(p.dtype == torch.float64 and p.requires_grad
               for p in gen.parameters())
    np.testing.assert_array_equal(
        gen.blocks["8"].conv1.w.detach().numpy(),
        tree64["blocks"]["8"]["conv1"]["w"])      # not rounded through f32
    frozen = Generator.from_jax_params(tcfg.GeneratorConfig(
        **CONFIGS["cond_proper"]), tree, "cpu")
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in frozen.parameters())
    z = torch.zeros(2, cfg.z_dim, dtype=torch.float64)
    out = gen(z, torch.tensor([0, 1]), step=2)
    assert out.dtype == torch.float64 and out.requires_grad


def test_init_generator_layout_matches_pgx():
    """The port's numpy init has pgx's keys, shapes and distribution."""
    kw = dict(jzoo.conditional_correct_generator(
        z_dim=16, num_classes=5, channel=16, max_step=4).__dict__)
    want = jax.device_get(j_init(jax.random.PRNGKey(0),
                                 jcfg.GeneratorConfig(**kw)))
    got = init_generator(tcfg.GeneratorConfig(**kw), seed=0)

    def leaves(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(leaves(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: np.asarray(v)})
        return out
    lw, lg = leaves(want), leaves(got)
    assert sorted(lw) == sorted(lg)
    for k in lw:
        assert lg[k].shape == lw[k].shape and lg[k].dtype == np.float32, k
        if k.endswith("/b"):
            assert not lg[k].any(), k
    w = lg["blocks/8/conv1/w"]
    assert abs(w.mean()) < 0.05 and abs(w.std() - 1) < 0.05


def test_zoo_factories_match_pgx():
    pairs = [
        (tzoo.conditional_correct_generator(z_dim=512, num_classes=10,
                                            channel=512, max_step=6),
         jzoo.conditional_correct_generator(z_dim=512, num_classes=10,
                                            channel=512, max_step=6)),
        (tzoo.correct_generator(), jzoo.correct_generator()),
        (tzoo.mnist_generator(channel=8), jzoo.mnist_generator(channel=8)),
        (tzoo.conditional_correct_grown(8)[0],
         jzoo.conditional_correct_grown(8)[0]),
    ]
    for t, j in pairs:
        assert t.__dict__ == j.__dict__
    with pytest.raises(ValueError):
        tzoo.conditional_correct_grown(12, channel=4)


def test_import_leaves_jax_and_pgx_out():
    code = ("import sys, pgx_torch, pgx_torch.serve, pgx_torch.cli.serve, "
            "pgx_torch.ops.kernels, pgx_torch.models.discriminator, "
            "pgx_torch.train.wgan, chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'pgx' or "
            "m.startswith('pgx.')]\n"
            "assert not bad, bad\nprint('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
