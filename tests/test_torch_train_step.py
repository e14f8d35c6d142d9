"""pgx_torch's train step against pgx's ``make_train_step`` on the CPU.

The conditional "proper" family (the flagship's), tiny: channel 8, z_dim 8,
4 stages in use of 6 (so some parameters are off the graph), batch 4, f64 in
both packages.  pgx's initial state is carried across with
``train_state_from_jax``; z and eps are pgx's own draws, made by splitting
``state["rng"]`` exactly as its step does, and fed to the port's step.

Tolerances, per quantity (f64, the same arithmetic in another order):
  * metrics: rtol 1e-9 (atol 1e-12);
  * gradients: with beta1 = 0 Adam's first moment IS the gradient, so
    ``mu`` is compared at 1e-9 of the largest gradient entry of its tensor,
    and ``nu`` likewise;
  * parameters and the EMA: atol 1e-9.  Adam at beta1 = 0 moves a weight
    by lr * g / (|g| + 1e-8), which turns a rounding-size difference in a
    tiny gradient into a visible step, so gradients are compared first and
    a parameter mismatch alone cannot be read;
  * Adam's count and ``iteration``: exact.

bf16 is not compared here: pgx's default path sums the pixel-norm statistic
in bf16 while the port's kernels (and their plain versions) sum in f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.models import zoo as jzoo
from pgx.train import wgan as jwgan
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import wgan as twgan

B, NUM_CLASSES = 4, 3
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=4, dtype="float64")
JG = jzoo.conditional_correct_generator(channel=8, **KW)
JD = jzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW.items() if k != "z_dim"})
TG = tzoo.conditional_correct_generator(channel=8, **KW)
TD = tzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW.items() if k != "z_dim"})

_JITTED = {}


def _jax_step(tc_kw, **kw):
    """pgx's jitted step, one compile per distinct variant in this file."""
    key = (tuple(sorted(tc_kw.items())), tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jwgan.make_train_step(
            JG, JD, jwgan.TrainConfig(**tc_kw), donate=False, **kw)
    return _JITTED[key]


def _initial_state(seed=0):
    """pgx's initial state with f64 parameters and fresh Adam state."""
    tc = jwgan.TrainConfig()
    state = jwgan.init_train_state(jax.random.PRNGKey(seed), JG, JD, tc)
    f64 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float64), t)
    state["g"], state["d"] = f64(state["g"]), f64(state["d"])
    state["g_ema"] = jax.tree.map(jnp.copy, state["g"])
    opt = jwgan.make_optimizer(tc)
    state["opt_g"], state["opt_d"] = opt.init(state["g"]), opt.init(state["d"])
    return state


def _draws(jstate):
    """z and eps as pgx's step draws them from ``state['rng']``."""
    _, kz, keps, _, _, _ = jax.random.split(jstate["rng"], 6)
    z = jax.random.normal(kz, (B, JG.z_dim), jnp.float32)
    eps = jax.random.uniform(keps, (B, 1, 1, 1), jnp.float64)
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(eps))


def _batch(step, seed):
    rng = np.random.RandomState(seed)
    res = JG.resolution(step)
    return (rng.randn(B, res, res, 3),
            rng.randint(0, NUM_CLASSES, B).astype(np.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close_rel_to_max(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-9 * scale, f"{what}: err {err} at scale {scale}"


def _compare(tstate, tmetrics, jstate, jmetrics, where):
    for k in ("d_loss", "grad_penalty", "real_score", "fake_score",
              "d_total", "g_loss", "ada_r"):
        np.testing.assert_allclose(
            float(tmetrics[k]), float(jmetrics[k]), rtol=1e-9, atol=1e-12,
            err_msg=f"{where}: metric {k}")
    assert float(tmetrics["ada_p"]) == 0.0
    assert set(tmetrics) == set(twgan.METRICS) == set(jmetrics)
    # gradients first (beta1 = 0: mu is the gradient), then second moments
    for net, opt in (("d", "opt_d"), ("g", "opt_g")):
        adam = jstate[opt][0]
        assert tstate[opt]["count"] == int(adam.count), f"{where}: {opt}"
        for moment in ("mu", "nu"):
            want = _flat(getattr(adam, moment))
            got = tstate[opt][moment]
            assert got.keys() == want.keys()
            for name in want:
                assert got[name].dtype == torch.float64
                _close_rel_to_max(got[name].numpy(), want[name],
                                  f"{where}: {opt}.{moment}.{name}")
    for net in ("d", "g", "g_ema"):
        want = _flat(jstate[net])
        got = dict(tstate[net].named_parameters())
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(
                got[name].detach().numpy(), want[name], rtol=0, atol=1e-9,
                err_msg=f"{where}: {net}.{name}")
    assert tstate["iteration"] == int(jstate["iteration"])


def _run(plan, tc_kw=None, seed=0):
    """Run ``plan`` — a list of dicts (step, fading, alpha and the step's
    keyword arguments) — through both packages from one initial state,
    comparing after every iteration."""
    tc_kw = tc_kw or {}
    jstate = _initial_state(seed)
    ttc = twgan.TrainConfig(**tc_kw)
    tstate = twgan.train_state_from_jax(TG, TD, ttc, jax.device_get(jstate),
                                        "cpu")
    for i, it in enumerate(plan):
        it = dict(it)
        alpha = it.pop("alpha", 1.0)
        real, labels = _batch(it["step"], seed=10 + i)
        z, eps = _draws(jstate)
        jstate, jmetrics = _jax_step(tc_kw, **it)(
            jstate, jnp.asarray(real), jnp.asarray(labels),
            jnp.asarray(alpha, jnp.float64))
        tstep = twgan.make_train_step(TG, TD, ttc, **it)
        tstate, tmetrics = tstep(tstate, torch.from_numpy(real),
                                 torch.from_numpy(labels), alpha, z=z,
                                 eps=eps)
        _compare(tstate, tmetrics, jax.device_get(jstate), jmetrics,
                 f"iteration {i + 1} of {plan}")
    return tstate


def test_state_is_carried_in_f64():
    jstate = jax.device_get(_initial_state())
    tstate = twgan.train_state_from_jax(TG, TD, twgan.TrainConfig(), jstate,
                                        "cpu")
    for net in ("g", "d", "g_ema"):
        want = _flat(jstate[net])
        got = dict(tstate[net].named_parameters())
        assert got.keys() == want.keys()
        for name, p in got.items():
            assert p.dtype == torch.float64
            assert p.requires_grad == (net != "g_ema")
            np.testing.assert_array_equal(p.detach().numpy(), want[name])
    assert tstate["iteration"] == 0 and tstate["opt_d"]["count"] == 0


def test_one_and_two_iterations_match_pgx():
    _run([dict(step=3, fading=False)] * 2)


def test_fading_iteration_matches_pgx():
    _run([dict(step=3, fading=True, alpha=0.6)], seed=1)


def test_growth_pair_matches_pgx():
    """step, then step + 1: the stage that joins the graph has seen zero
    gradients, a decayed nu and the optimizer's shared count."""
    tstate = _run([dict(step=2, fading=False),
                   dict(step=3, fading=True, alpha=0.3)], seed=2)
    assert tstate["opt_g"]["count"] == 2


def test_d_only_iteration_matches_pgx():
    tstate = _run([dict(step=3, fading=False, update_g=False)], seed=3)
    assert tstate["opt_g"]["count"] == 0 and tstate["opt_d"]["count"] == 1


def test_lazy_gp_iteration_matches_pgx():
    _run([dict(step=3, fading=False, apply_gp=False),
          dict(step=3, fading=False)], tc_kw=dict(gp_every=2), seed=4)


def test_fused_g_matches_pgx():
    _run([dict(step=3, fading=False)], tc_kw=dict(fused_g=True), seed=5)


def test_d_concat_matches_pgx():
    _run([dict(step=3, fading=False),
          dict(step=3, fading=False, apply_gp=False)],
         tc_kw=dict(d_concat=True), seed=6)


def test_init_train_state_and_draws():
    tc = twgan.TrainConfig()
    state = twgan.init_train_state(TG, TD, tc, seed=3, device="cpu")
    again = twgan.init_train_state(TG, TD, tc, seed=3, device="cpu")
    for (n, p), q, e in zip(state["g"].named_parameters(),
                            again["g"].parameters(),
                            state["g_ema"].parameters()):
        assert p.requires_grad and not e.requires_grad
        assert torch.equal(p, q) and torch.equal(p, e), n
    assert all(p.requires_grad for p in state["d"].parameters())
    assert state["opt_g"]["mu"].keys() == dict(
        state["g"].named_parameters()).keys()
    rng = torch.Generator().manual_seed(0)
    z, eps = twgan.draw_z_eps(TG, 5, rng)
    assert z.shape == (5, 8) and eps.shape == (5, 1, 1, 1)
    assert 0 <= float(eps.min()) and float(eps.max()) < 1


def test_train_config_validation():
    for kw in (dict(gp_mode="forward"), dict(weights_cast="never"),
               dict(remat_policy="some"), dict(gp_every=0),
               dict(n_critic=0), dict(d_concat=True, fused_g=True)):
        with pytest.raises(ValueError):
            twgan.TrainConfig(**kw)
        with pytest.raises(ValueError):
            jwgan.TrainConfig(**kw)
    with pytest.raises(ValueError):     # as pgx: checked before "not ported"
        twgan.TrainConfig(d_concat=True, gp_mode="jvp")
    assert (dataclasses.asdict(twgan.TrainConfig())
            == dataclasses.asdict(jwgan.TrainConfig()))


@pytest.mark.parametrize("kw", [dict(gp_mode="jvp"), dict(remat=True),
                                dict(weights_cast="once")])
def test_train_config_refuses_unported_variants(kw):
    """Once refused, each variant is now accepted: the config is pgx's, and
    in f64 one iteration with it computes the default's (jvp: the same
    gradient in another order, 1e-12 of the largest entry; remat and the
    f64 cast: the same arithmetic)."""
    tc = twgan.TrainConfig(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jwgan.TrainConfig(**kw))
    jstate = jax.device_get(_initial_state(7))
    real, labels = _batch(3, seed=80)
    z, eps = _draws(jstate)
    out = []
    for cfg in (tc, twgan.TrainConfig()):
        state, metrics = twgan.make_train_step(TG, TD, cfg, step=3,
                                               fading=False)(
            twgan.train_state_from_jax(TG, TD, cfg, jstate, "cpu"),
            torch.from_numpy(real), torch.from_numpy(labels), 1.0, z=z,
            eps=eps)
        out.append((state, metrics))
    (got, gm), (want, wm) = out
    for k in twgan.METRICS:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-12,
                                   atol=1e-14, err_msg=k)
    for opt in ("opt_d", "opt_g"):
        for n, w in want[opt]["mu"].items():
            scale = max(w.abs().max().item(), 1e-30)
            assert (got[opt]["mu"][n] - w).abs().max().item() \
                <= 1e-12 * scale, (opt, n)
