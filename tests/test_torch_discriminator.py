"""pgx_torch's discriminator against pgx.discriminator_apply on the CPU.

pgx's own initial params (``jax.device_get(init_discriminator(...))``) are
carried over with ``Discriminator.from_jax_params``; images and labels are
numpy draws fed to both.  Four families (the flagship's label-plane
"proper" family, the projection head, the mnist single-conv blocks, the
legacy family), every step, fading off and on, f32.  Tolerance: atol/rtol
1e-4 — a chain of up to a dozen f32 convs and norms summed in another
order.
"""

import numpy as np
import pytest
import torch

import jax

from pgx.models import config as jcfg
from pgx.models import zoo as jzoo
from pgx.models.discriminator import discriminator_apply as j_apply
from pgx.models.discriminator import init_discriminator as j_init
from pgx_torch.models import config as tcfg
from pgx_torch.models import zoo as tzoo
from pgx_torch.models.discriminator import (Discriminator,
                                            init_discriminator)
from pgx_torch.ops import kernels as K

TOL = dict(atol=1e-4, rtol=1e-4)
B = 4

# name -> DiscriminatorConfig kwargs shared by both packages
CONFIGS = {
    "cond_proper": jzoo.conditional_correct_discriminator_wgangp(
        feat_dim=16, num_classes=5, max_step=4).__dict__,
    "projection": jzoo.conditional_correct_discriminator_ada(
        feat_dim=8, num_classes=3, max_step=3).__dict__,
    "mnist": jzoo.mnist_discriminator(feat_dim=8).__dict__,
    "legacy_equal_embed": jzoo.conditional_discriminator_wgangp(
        feat_dim=16, num_classes=4, max_step=3, equal_embed=True).__dict__,
}
CASES = [(name, step) for name, kw in CONFIGS.items()
         for step in range(0 if kw["arch"] == "legacy" else 1,
                           kw["max_step"] + 1)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw in CONFIGS.items():
        jc = jcfg.DiscriminatorConfig(**kw)
        params = jax.device_get(j_init(jax.random.PRNGKey(1), jc))
        # nonzero biases, so a dropped or misplaced bias shows
        rng = np.random.RandomState(7)

        def with_bias(t):
            return {k: (with_bias(v) if isinstance(v, dict) else
                        (rng.randn(*v.shape).astype(np.float32) * 0.1
                         if k == "b" else v)) for k, v in t.items()}

        params = with_bias(params)
        tc = tcfg.DiscriminatorConfig(**kw)
        out[name] = (jc, params,
                     Discriminator.from_jax_params(tc, params, "cpu"))
    return out


@pytest.mark.parametrize("name,step", CASES)
def test_discriminator_matches_pgx(models, name, step):
    jc, params, disc = models[name]
    rng = np.random.RandomState(step)
    res = 4 * 2 ** jc.entry_stage(step)
    img = rng.randn(B, res, res, jc.img_channels).astype(np.float32)
    labels = (rng.randint(0, jc.num_classes, B).astype(np.int32)
              if jc.conditioning != "none" else None)
    t_lab = torch.from_numpy(labels) if labels is not None else None
    for fading, alpha in [(False, 1.0), (True, 0.0), (True, 0.3)]:
        if fading and jc.entry_stage(step) == 0:
            continue        # no lower stage to blend with
        want = np.asarray(j_apply(params, jc, img, labels, step=step,
                                  alpha=alpha, fading=fading))
        with torch.no_grad():
            got = disc(torch.from_numpy(img), t_lab, step=step, alpha=alpha,
                       fading=fading)
        assert got.shape == want.shape
        assert want.shape == ((B,) if jc.conditioning == "projection"
                              else (B, 1))
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(
            (name, step, fading, alpha)), **TOL)


@pytest.mark.parametrize("name", ["cond_proper", "projection"])
def test_stddev_groups_score_slices_as_separate_calls(models, name):
    """One 3B forward with per-slice stddev equals three B forwards, in
    the port and in pgx."""
    jc, params, disc = models[name]
    step = jc.max_step
    rng = np.random.RandomState(0)
    res = 4 * 2 ** jc.entry_stage(step)
    img = rng.randn(3 * B, res, res, jc.img_channels).astype(np.float32)
    labels = rng.randint(0, jc.num_classes, 3 * B).astype(np.int32)
    with torch.no_grad():
        cat = disc(torch.from_numpy(img), torch.from_numpy(labels),
                   step=step, stddev_groups=3)
        parts = torch.cat([
            disc(torch.from_numpy(img[i:i + B]),
                 torch.from_numpy(labels[i:i + B]), step=step)
            for i in range(0, 3 * B, B)])
    np.testing.assert_allclose(cat.numpy(), parts.numpy(), atol=1e-5,
                               rtol=1e-5)
    want = np.asarray(j_apply(params, jc, img, labels, step=step,
                              stddev_groups=3))
    np.testing.assert_allclose(cat.numpy(), want, **TOL)


def test_from_jax_params_loads_by_name_strictly(models):
    jc, params, disc = models["cond_proper"]
    flat = dict(disc.named_parameters())
    np.testing.assert_array_equal(
        flat["blocks.8.conv2.w"].detach().numpy(),
        params["blocks"]["8"]["conv2"]["w"])
    np.testing.assert_array_equal(
        flat["embeddings.16.w"].detach().numpy(),
        params["embeddings"]["16"]["w"])
    assert flat["blocks.4.conv1.w"].shape == (3, 3, 17, 16)
    assert flat["blocks.4.conv2.w"].shape == (4, 4, 16, 16)
    assert flat["linear.w"].shape == (16, 1)
    assert all(p.requires_grad for p in flat.values())
    tc = tcfg.DiscriminatorConfig(**CONFIGS["cond_proper"])
    missing = {k: v for k, v in params.items() if k != "linear"}
    with pytest.raises(RuntimeError, match="linear"):
        Discriminator.from_jax_params(tc, missing, "cpu")
    extra = dict(params, surplus={"w": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="surplus"):
        Discriminator.from_jax_params(tc, extra, "cpu")


def test_from_jax_params_keeps_f64():
    tc = tcfg.DiscriminatorConfig(**dict(CONFIGS["projection"],
                                         dtype="float64"))
    tree = init_discriminator(tc, seed=0)
    f64 = lambda t: {k: (f64(v) if isinstance(v, dict)
                         else v.astype(np.float64)) for k, v in t.items()}
    disc = Discriminator.from_jax_params(tc, f64(tree), "cpu")
    assert all(p.dtype == torch.float64 for p in disc.parameters())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_discriminator_has_pgx_layout(models, name):
    jc, params, _ = models[name]
    tc = tcfg.DiscriminatorConfig(**CONFIGS[name])
    ours = init_discriminator(tc, seed=0)

    def shapes(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(shapes(v, f"{pre}{k}.") if isinstance(v, dict)
                       else {pre + k: (v.shape, str(v.dtype))})
        return out

    assert shapes(ours) == shapes(params)
    Discriminator.from_jax_params(tc, ours, "cpu")     # loads strictly
    assert float(np.abs(ours["linear"]["b"]).max()) == 0.0


def test_discriminator_never_launches_kernel_c(models, monkeypatch):
    """The discriminator's convs go cuDNN conv -> kernel A; the fused conv
    (differentiable once only) is never called from it."""
    from pgx_torch.core import layers as TL
    calls = {"A": 0}

    def no_c(*a, **k):
        raise AssertionError("kernel C called from the discriminator")

    def count_a(*a, **k):
        calls["A"] += 1
        return K.bias_pixelnorm_lrelu(*a, **k)

    monkeypatch.setattr(TL, "conv3x3_epilogue", no_c)
    monkeypatch.setattr(TL, "bias_pixelnorm_lrelu", count_a)
    jc, _, disc = models["cond_proper"]
    img = torch.randn(B, 32, 32, 3)
    disc(img, torch.zeros(B, dtype=torch.long), step=4)
    assert calls["A"] == 2 * 4      # two convs in each of the four stages


def test_zoo_discriminator_factories_match_pgx():
    names = ["legacy_discriminator", "conditional_discriminator_wgangp",
             "correct_discriminator",
             "conditional_correct_discriminator_wgangp",
             "conditional_correct_discriminator_ada", "mnist_discriminator",
             "mnist_conditional_discriminator_wgangp",
             "mnist_conditional_discriminator_ada"]
    for n in names:
        assert getattr(tzoo, n)().__dict__ == getattr(jzoo, n)().__dict__, n
    t = tzoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    j = jzoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    assert t.__dict__ == j.__dict__
    tg, td = tzoo.conditional_correct_grown(8)
    jg, jd = jzoo.conditional_correct_grown(8)
    assert tg.__dict__ == jg.__dict__ and td.__dict__ == jd.__dict__


def test_discriminator_config_checks():
    for kw in (dict(stage_in=(8, 8), stage_out=(8,)), dict(arch="other"),
               dict(block_type="triple"), dict(conditioning="concat"),
               dict(conditioning="projection"),
               dict(stage_in=(8,) * 3, stage_out=(8,) * 3, max_step=6),
               dict(stage_in=(8, 4), stage_out=(8, 4), max_step=1)):
        with pytest.raises(ValueError):
            tcfg.DiscriminatorConfig(**kw)
        with pytest.raises(AssertionError):
            jcfg.DiscriminatorConfig(**kw)
    c = tcfg.DiscriminatorConfig(stage_in=(8, 8, 4), stage_out=(8, 8, 8),
                                 arch="proper", max_step=3)
    assert (c.num_stages, c.feat_dim, c.entry_stage(9)) == (3, 8, 2)
