"""pgx_torch's ADA-augmented train step against pgx's on the CPU.

The tiny conditional "proper" pair of tests/test_torch_train_step.py at
step 2 (16px), batch 4, f64 parameters and images in both packages.  pgx's
state is carried across with ``train_state_from_jax`` (the ``ada``
controller state included); z, eps and the three augmentation draw sources
are pgx's own, made by splitting ``state["rng"]`` exactly as its step does
(``kz, keps, kar, kaf, kag``) and handing the pipe's 48 sub-keys out in
call order.

Tolerances.  The un-augmented step matches pgx to 1e-9 (f64 in another
order).  The augmented step cannot: the pipe's transform matrices are f32
in both packages whatever the image type, and ``cos``, ``sin``, ``exp2``
and the 3x3 products differ in their last f32 bit between XLA's CPU code
and torch's, which moves the augmented images by up to ~1e-5
(tests/test_torch_augment.py) and everything downstream with them.  So
metrics are held to 1e-4 relative (1e-5 absolute; measured up to 1.2e-5
relative), gradients (Adam's ``mu`` at beta1 = 0) and second moments to
1e-4 of each tensor's largest entry (measured up to 6e-6), and the
controller's state exactly up to f32 rounding (it sees only the signs of
the real logits).  Parameters are not compared: Adam at
beta1 = 0 moves a weight by lr * g / (|g| + 1e-8), which turns a 1e-5
difference in a near-zero gradient entry into a +-lr step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.augment import AdaConfig as JAdaConfig
from pgx.augment import pipe as jpipe
from pgx.models import zoo as jzoo
from pgx.train import wgan as jwgan
from pgx_torch.augment import AdaConfig, AugmentConfig, bgc_config
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import wgan as twgan
from tests.test_torch_augment import JaxDraws

B, NUM_CLASSES, STEP = 4, 3, 2
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=3, dtype="float64")
DKW = {k: v for k, v in KW.items() if k != "z_dim"}
JG = jzoo.conditional_correct_generator(channel=8, **KW)
JD = jzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
TG = tzoo.conditional_correct_generator(channel=8, **KW)
TD = tzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)

METRIC_RTOL, METRIC_ATOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
_JITTED = {}


def _jax_step(tc_kw, **kw):
    key = (tuple(sorted(tc_kw.items())), tuple(sorted(
        (k, str(v)) for k, v in kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jwgan.make_train_step(
            JG, JD, jwgan.TrainConfig(**tc_kw), step=STEP, fading=False,
            donate=False, **kw)
    return _JITTED[key]


def _initial_state(seed=0, ada_p=0.0):
    tc = jwgan.TrainConfig()
    state = jwgan.init_train_state(jax.random.PRNGKey(seed), JG, JD, tc)
    f64 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float64), t)
    state["g"], state["d"] = f64(state["g"]), f64(state["d"])
    state["g_ema"] = jax.tree.map(jnp.copy, state["g"])
    opt = jwgan.make_optimizer(tc)
    state["opt_g"], state["opt_d"] = opt.init(state["g"]), opt.init(state["d"])
    state["ada"] = dict(state["ada"], p=jnp.asarray(ada_p, jnp.float32))
    return state


def _draws(jstate):
    """z, eps and the three draw sources as pgx's step makes them."""
    _, kz, keps, kar, kaf, kag = jax.random.split(jstate["rng"], 6)
    z = jax.random.normal(kz, (B, JG.z_dim), jnp.float32)
    eps = jax.random.uniform(keps, (B, 1, 1, 1), jnp.float64)
    return (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(eps)),
            (JaxDraws(kar), JaxDraws(kaf), JaxDraws(kag)))


def _batch(seed):
    rng = np.random.RandomState(seed)
    res = JG.resolution(STEP)
    return (np.tanh(rng.randn(B, res, res, 3)),
            rng.randint(0, NUM_CLASSES, B).astype(np.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _compare(tstate, tmetrics, jstate, jmetrics, where):
    assert set(tmetrics) == set(twgan.METRICS) == set(jmetrics)
    for k in twgan.METRICS:
        np.testing.assert_allclose(
            float(tmetrics[k]), float(jmetrics[k]), rtol=METRIC_RTOL,
            atol=METRIC_ATOL, err_msg=f"{where}: metric {k}")
    worst = 0.0
    for opt in ("opt_d", "opt_g"):
        adam = jstate[opt][0]
        assert tstate[opt]["count"] == int(adam.count), f"{where}: {opt}"
        for moment in ("mu", "nu"):
            want = _flat(getattr(adam, moment))
            got = tstate[opt][moment]
            assert got.keys() == want.keys()
            for name in want:
                scale = max(float(np.abs(want[name]).max()), 1e-30)
                err = float(np.abs(got[name].numpy() - want[name]).max())
                worst = max(worst, err / scale)
                assert err <= GRAD_TOL * scale, (
                    f"{where}: {opt}.{moment}.{name}: err {err} at scale "
                    f"{scale}")
    for k, v in jstate["ada"].items():
        assert tstate["ada"][k].dtype == torch.float32
        np.testing.assert_allclose(float(tstate["ada"][k]), float(v),
                                   rtol=1e-6, atol=0,
                                   err_msg=f"{where}: ada.{k}")
    assert tstate["iteration"] == int(jstate["iteration"])
    return worst


def _run(iterations, tc_kw=None, seed=0, ada_p=0.0, jkw=None, tkw=None):
    """``iterations`` ADA steps through both packages from one state,
    compared after each; ``jkw``/``tkw`` are the augmentation arguments of
    pgx's and the port's ``make_train_step``."""
    tc_kw = tc_kw or {}
    jstate = _initial_state(seed, ada_p)
    ttc = twgan.TrainConfig(**tc_kw)
    tstate = twgan.train_state_from_jax(TG, TD, ttc, jax.device_get(jstate),
                                        "cpu")
    np.testing.assert_allclose(float(tstate["ada"]["p"]), ada_p, rtol=1e-7)
    tstep = twgan.make_train_step(TG, TD, ttc, step=STEP, fading=False,
                                  **tkw)
    metrics = []
    for i in range(iterations):
        real, labels = _batch(seed=20 + i)
        z, eps, sources = _draws(jstate)
        jstate, jm = _jax_step(tc_kw, **jkw)(
            jstate, jnp.asarray(real), jnp.asarray(labels),
            jnp.asarray(1.0, jnp.float64))
        tstate, tm = tstep(tstate, torch.from_numpy(real),
                           torch.from_numpy(labels), 1.0, z=z, eps=eps,
                           aug_draws=sources)
        _compare(tstate, tm, jax.device_get(jstate), jm,
                 f"iteration {i + 1}")
        metrics.append({k: float(v) for k, v in tm.items()})
    return tstate, metrics


def test_ada_state_is_carried_and_initialized():
    jstate = jax.device_get(_initial_state(ada_p=0.25))
    jstate["ada"]["count"] = np.float32(8.0)
    jstate["ada"]["sign_sum"] = np.float32(-2.0)
    tstate = twgan.train_state_from_jax(TG, TD, twgan.TrainConfig(), jstate,
                                        "cpu")
    assert {k: float(v) for k, v in tstate["ada"].items()} == {
        "p": 0.25, "sign_sum": -2.0, "count": 8.0}
    fresh = twgan.init_train_state(TG, TD, twgan.TrainConfig(), device="cpu")
    assert {k: float(v) for k, v in fresh["ada"].items()} == {
        "p": 0.0, "sign_sum": 0.0, "count": 0.0}
    assert all(v.dtype == torch.float32 and v.ndim == 0
               for v in fresh["ada"].values())
    bad = dict(jstate, ada={"p": np.float32(0.0)})
    with pytest.raises(ValueError, match="ada state"):
        twgan.train_state_from_jax(TG, TD, twgan.TrainConfig(), bad, "cpu")


def test_ada_controller_step_matches_pgx_over_two_iterations():
    """bgc policy, shear warp, the controller on: p starts at 0.6 so the
    pipe really transforms; interval_batches=2 makes the second iteration
    trigger an update of p."""
    tstate, metrics = _run(
        2, ada_p=0.6,
        jkw=dict(augment_cfg=jpipe.bgc_config(),
                 ada_cfg=JAdaConfig(interval_batches=2, ada_length=100)),
        tkw=dict(augment_cfg=bgc_config(),
                 ada_cfg=AdaConfig(interval_batches=2, ada_length=100)))
    assert metrics[0]["ada_p"] == pytest.approx(0.6)
    assert metrics[1]["ada_p"] != pytest.approx(0.6)     # the trigger fired
    assert float(tstate["ada"]["count"]) == 0.0
    assert metrics[1]["ada_p"] == pytest.approx(float(tstate["ada"]["p"]))


def test_fixed_p_step_matches_pgx_and_reports_the_applied_p():
    """augment_cfg without ada_cfg: the fixed augment_p applies, the metric
    reports it, and the controller's state stays untouched."""
    tstate, metrics = _run(
        1, seed=1,
        jkw=dict(augment_cfg=jpipe.bgc_config(noise=1), augment_p=0.9),
        tkw=dict(augment_cfg=bgc_config(noise=1), augment_p=0.9))
    assert metrics[0]["ada_p"] == pytest.approx(0.9)
    assert float(tstate["ada"]["p"]) == 0.0
    assert float(tstate["ada"]["count"]) == 0.0


def test_fused_g_ada_step_matches_pgx():
    """fused_g: G's gradient comes from the joint pass, through the D
    step's augmentation draw."""
    _run(1, tc_kw=dict(fused_g=True), seed=2, ada_p=0.8,
         jkw=dict(augment_cfg=jpipe.bgc_config(), ada_cfg=JAdaConfig()),
         tkw=dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig()))


def test_gather_warp_d_concat_step_matches_pgx():
    """The oracle warp (upsample2d -> grid_sample -> downsample2d) under
    the batched-D dispatch."""
    _run(1, tc_kw=dict(d_concat=True), seed=3, ada_p=0.7,
         jkw=dict(augment_cfg=jpipe.bgc_config(warp_impl="gather"),
                  ada_cfg=JAdaConfig()),
         tkw=dict(augment_cfg=bgc_config(warp_impl="gather"),
                  ada_cfg=AdaConfig()))


def test_penalty_is_taken_at_the_augmented_endpoints():
    """x_hat interpolates the augmented real and the augmented, detached
    fake, and the pipe stays outside the double backward: the penalty of
    the ADA step equals pgx's (held above) and differs from the
    un-augmented step's on the same inputs."""
    kw = dict(augment_cfg=bgc_config(), augment_p=1.0)
    tc = twgan.TrainConfig()
    jstate = jax.device_get(_initial_state(seed=4))
    real, labels = _batch(seed=30)
    z, eps, sources = _draws(jstate)
    out = {}
    for name, step_kw, call_kw in (
            ("ada", kw, dict(aug_draws=sources)), ("plain", {}, {})):
        tstate = twgan.train_state_from_jax(TG, TD, tc, jstate, "cpu")
        step = twgan.make_train_step(TG, TD, tc, step=STEP, fading=False,
                                     **step_kw)
        _, m = step(tstate, torch.from_numpy(real), torch.from_numpy(labels),
                    1.0, z=z, eps=eps, **call_kw)
        out[name] = float(m["grad_penalty"])
    assert np.isfinite(out["ada"]) and out["ada"] != out["plain"]


def test_three_pipe_calls_use_three_draws(monkeypatch):
    """One call for the reals, one for the D step's fakes, one for the G
    step's, each with its own source; fused_g drops the G step's call."""
    seen = []
    inner = twgan.augment_pipe

    def spy(draws, images, cfg, p, **kw):
        seen.append((draws, images.requires_grad, float(p)))
        return inner(draws, images, cfg, p, **kw)

    monkeypatch.setattr(twgan, "augment_pipe", spy)
    acfg = AugmentConfig(xflip=1, brightness=1)
    real, labels = _batch(seed=40)
    for fused, calls in ((False, 3), (True, 2)):
        seen.clear()
        tc = twgan.TrainConfig(fused_g=fused)
        state = twgan.init_train_state(TG, TD, tc, seed=0, device="cpu")
        rng = torch.Generator().manual_seed(0)
        z, eps = twgan.draw_z_eps(TG, B, rng, torch.float64)
        sources = twgan.draw_augment_sources(rng)
        step = twgan.make_train_step(TG, TD, tc, step=STEP, fading=False,
                                     augment_cfg=acfg, augment_p=0.8)
        _, m = step(state, torch.from_numpy(real), torch.from_numpy(labels),
                    1.0, z=z, eps=eps, aug_draws=sources)
        assert len(seen) == calls
        assert len({id(s[0]) for s in seen}) == calls
        assert [s[0] for s in seen] == list(sources[:calls])
        # reals and the D step's fakes carry no graph; the G step's (or
        # the joint pass's) do
        assert [s[1] for s in seen] == [False, fused, True][:calls]
        assert all(s[2] == pytest.approx(0.8) for s in seen)
        assert float(m["ada_p"]) == pytest.approx(0.8)
        assert all(np.isfinite(float(v)) for v in m.values())
    with pytest.raises(ValueError, match="aug_draws"):
        step(state, torch.from_numpy(real), torch.from_numpy(labels), 1.0,
             z=z, eps=eps)
