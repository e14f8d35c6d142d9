"""The JVP form of the gradient penalty (``TrainConfig(gp_mode='jvp')``)
against pgx on the CPU.

Kernel A's tangent (``_BiasPixelNormLreluTangent``, its plain version on the
CPU) is held against ``jax.jvp`` of pgx's ``bias_pixelnorm_lrelu`` with its
Pallas kernel in interpret mode (f32, 1e-5), and its backward, built from
A's backward and second-derivative Functions, against autograd through the
plain rule (f64, gradcheck).  ``conv2d_gradfix``'s forward-mode rule is held
against ``F.conv2d`` under forward AD.

The step: the tiny conditional "proper" pair of
``tests/test_torch_train_step.py`` (f64, pgx's draws, pgx's state carried
across) at 1e-9, as the reverse penalty; the ADA step at its 1e-4
(``tests/test_torch_train_ada.py``: the transform matrices are f32 in both
packages); the port's jvp step against its own reverse step (the same
gradient, in another order) at 1e-12 of each tensor's largest entry; an f32
jvp step through the kernels' Functions against pgx at 1e-4 of each
tensor's largest gradient entry.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pgx.augment import AdaConfig as JAdaConfig
from pgx.augment import pipe as jpipe
from pgx.models import zoo as jzoo
from pgx.train import wgan as jwgan
from pgx_torch.augment import AdaConfig, bgc_config
from pgx_torch.models import zoo as tzoo
from pgx_torch.ops import conv2d_gradfix
from pgx_torch.ops.kernels import epilogue as E
from pgx_torch.train import wgan as twgan
from tests import test_torch_train_ada as ada
from tests import test_torch_train_step as ts
from tests.test_torch_kernels import pallas_interpret  # noqa: F401

JVP = dict(gp_mode="jvp")


def _rand(shape, seed, scale=1.0, dtype=np.float32):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# Kernel A's tangent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_db", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (2, 8, 8, 256),
                                   (1, 4, 4, 512)])
def test_tangent_matches_pgx_jvp(pallas_interpret, shape, with_db):
    """pgx's custom_jvp rule under jax.jvp, its primal the Pallas kernel in
    interpret mode, against the tangent Function: f32, 1e-5."""
    Ep = pallas_interpret["epilogue"]
    y, b = _rand(shape, 1), _rand(shape[-1:], 2, 0.3)
    dy = _rand(shape, 3)
    db = _rand(shape[-1:], 4) if with_db else np.zeros(shape[-1:],
                                                        np.float32)
    out, tan = jax.jvp(lambda a, c: Ep.bias_pixelnorm_lrelu(a, c, 0.2),
                       (jnp.asarray(y), jnp.asarray(b)),
                       (jnp.asarray(dy), jnp.asarray(db)))
    got = E.bias_pixelnorm_lrelu_tangent(
        torch.from_numpy(y), torch.from_numpy(b), torch.from_numpy(dy),
        torch.from_numpy(db) if with_db else None, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(tan), atol=1e-5,
                               rtol=1e-5)
    # the same tangent through forward AD of the kernel's Function
    with fwAD.dual_level():
        dual = E.bias_pixelnorm_lrelu(
            fwAD.make_dual(torch.from_numpy(y), torch.from_numpy(dy)),
            fwAD.make_dual(torch.from_numpy(b), torch.from_numpy(db)))
        primal, tangent = fwAD.unpack_dual(dual)
    np.testing.assert_allclose(primal.numpy(), np.asarray(out), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tangent.numpy(), np.asarray(tan), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("with_db", [False, True])
def test_tangent_backward_gradcheck(with_db):
    rng = np.random.RandomState(5)
    y = torch.from_numpy(rng.randn(2, 3, 3, 16)).requires_grad_(True)
    b = torch.from_numpy(rng.randn(16) * 0.3).requires_grad_(True)
    dy = torch.from_numpy(rng.randn(2, 3, 3, 16)).requires_grad_(True)
    db = (torch.from_numpy(rng.randn(16)).requires_grad_(True) if with_db
          else None)
    fn = lambda *a: E._BiasPixelNormLreluTangent.apply(
        *a[:3], a[3] if with_db else None, 0.2, 1e-8)
    inputs = (y, b, dy, db) if with_db else (y, b, dy)
    assert torch.autograd.gradcheck(fn, inputs)


def test_tangent_backward_is_a_vjp_and_a_second_derivative(monkeypatch):
    """For the cotangent c the tangent's gradients are A's VJP in (dy, db)
    and A's second derivative with g = c, (ddy, ddb) = (dy, db) in (y, b):
    equal to autograd through the plain rule in f64 to 1e-12, and computed
    by exactly one call of each Function's plain version (the backward and
    second-order kernels on the card), never the plain tangent."""
    rng = np.random.RandomState(6)
    y, dy = (torch.from_numpy(rng.randn(3, 4, 4, 24)).requires_grad_(True)
             for _ in range(2))
    b, db = (torch.from_numpy(rng.randn(24) * 0.3).requires_grad_(True)
             for _ in range(2))
    c = torch.from_numpy(rng.randn(3, 4, 4, 24))
    calls = {"bwd": 0, "bwd2": 0, "jvp": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(E, "bias_pixelnorm_lrelu_backward_ref",
                        counted("bwd", E.bias_pixelnorm_lrelu_backward_ref))
    monkeypatch.setattr(E, "second_order_ref",
                        counted("bwd2", E.second_order_ref))
    out = E.bias_pixelnorm_lrelu_tangent(y, b, dy, db)
    got = torch.autograd.grad(out, (y, b, dy, db), c)
    assert calls == {"bwd": 1, "bwd2": 1, "jvp": 0}
    want = torch.autograd.grad(
        E.bias_pixelnorm_lrelu_jvp_ref(y, b, dy, db), (y, b, dy, db), c)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# conv2d_gradfix under forward mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["x", "w", "both"])
@pytest.mark.parametrize("padding", [0, 1])
def test_conv_jvp_matches_conv2d_forward_ad(which, padding):
    """The tangent of the port's conv against F.conv2d's own forward-mode
    rule, and reverse mode over the tangent against reverse over F.conv2d's
    (f64, 1e-12)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 8, 6, 6))
    w = torch.from_numpy(rng.randn(4, 8, 3, 3)).requires_grad_(True)
    tx = torch.from_numpy(rng.randn(2, 8, 6, 6)) if which != "w" else None
    tw = torch.from_numpy(rng.randn(4, 8, 3, 3)) if which != "x" else None
    c = torch.from_numpy(rng.randn(2, 4, 6 + 2 * padding - 2,
                                   6 + 2 * padding - 2))
    results = []
    for conv in (lambda a, k: conv2d_gradfix.conv2d(a, k, padding),
                 lambda a, k: F.conv2d(a, k, padding=padding)):
        with fwAD.dual_level():
            xd = x if tx is None else fwAD.make_dual(x, tx)
            wd = w if tw is None else fwAD.make_dual(w, tw)
            primal, tangent = fwAD.unpack_dual(conv(xd, wd))
        gw, = torch.autograd.grad(tangent, w, c)
        results.append((primal.detach(), tangent.detach(), gw))
    for got, want in zip(*results):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12,
                                   rtol=0)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def test_jvp_one_and_two_iterations_match_pgx():
    ts._run([dict(step=3, fading=False)] * 2, tc_kw=JVP)


def test_jvp_fading_iteration_matches_pgx():
    ts._run([dict(step=3, fading=True, alpha=0.6)], tc_kw=JVP, seed=1)


def test_jvp_fused_g_matches_pgx():
    ts._run([dict(step=3, fading=False)], tc_kw=dict(JVP, fused_g=True),
            seed=5)


def test_jvp_lazy_gp_matches_pgx():
    ts._run([dict(step=3, fading=False, apply_gp=False),
             dict(step=3, fading=False)], tc_kw=dict(JVP, gp_every=2),
            seed=4)


def test_jvp_ada_step_matches_pgx():
    """The recipe's settings on the tiny pair: ADA with the controller
    (shear warp), fused_g, the penalty every 2 iterations (lambda x 2), two
    iterations: 1e-4, as the ADA step."""
    ada._run(2, tc_kw=dict(JVP, fused_g=True, gp_every=2), ada_p=0.6,
             jkw=dict(augment_cfg=jpipe.bgc_config(),
                      ada_cfg=JAdaConfig(interval_batches=2,
                                         ada_length=100)),
             tkw=dict(augment_cfg=bgc_config(),
                      ada_cfg=AdaConfig(interval_batches=2, ada_length=100)))


def _port_state(seed=0):
    jstate = jax.device_get(ts._initial_state(seed))
    return jstate, lambda tc: twgan.train_state_from_jax(ts.TG, ts.TD, tc,
                                                         jstate, "cpu")


def test_jvp_step_equals_the_reverse_step():
    """The surrogate's gradient is the penalty's: the port's jvp and
    reverse steps agree to 1e-12 of each tensor's largest gradient entry
    (f64), metrics to 1e-12."""
    jstate, fresh = _port_state(2)
    real, labels = ts._batch(3, seed=30)
    z, eps = ts._draws(jstate)
    out = {}
    for mode in ("reverse", "jvp"):
        tc = twgan.TrainConfig(gp_mode=mode)
        state, metrics = twgan.make_train_step(
            ts.TG, ts.TD, tc, step=3, fading=False)(
            fresh(tc), torch.from_numpy(real), torch.from_numpy(labels), 1.0,
            z=z, eps=eps)
        out[mode] = (state, metrics)
    (rs, rm), (js, jm) = out["reverse"], out["jvp"]
    for k in twgan.METRICS:
        np.testing.assert_allclose(float(jm[k]), float(rm[k]), rtol=1e-12,
                                   atol=1e-14, err_msg=k)
    for opt in ("opt_d", "opt_g"):
        for n, want in rs[opt]["mu"].items():
            scale = max(want.abs().max().item(), 1e-30)
            err = (js[opt]["mu"][n] - want).abs().max().item()
            assert err <= 1e-12 * scale, (opt, n, err, scale)


# the f32 pair: the kernels' Functions take f32 (their plain versions here)
KW32 = dict(ts.KW, dtype="float32")
JG32 = jzoo.conditional_correct_generator(channel=8, **KW32)
JD32 = jzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW32.items() if k != "z_dim"})
TG32 = tzoo.conditional_correct_generator(channel=8, **KW32)
TD32 = tzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW32.items() if k != "z_dim"})


def test_f32_jvp_step_through_the_functions_matches_pgx(monkeypatch):
    """f32 compute: every epilogue of D is kernel A's Function (the plain
    versions inside), the dual forward runs A's tangent Function.  Metrics
    to 1e-4 relative, gradients to 1e-4 of each tensor's largest entry, as
    the ADA step (the f32 penalty is ill-conditioned)."""
    calls = {"jvp": 0}
    ref = E.bias_pixelnorm_lrelu_jvp_ref

    def counted(*a, **k):
        calls["jvp"] += 1
        return ref(*a, **k)
    monkeypatch.setattr(E, "bias_pixelnorm_lrelu_jvp_ref", counted)
    jtc = jwgan.TrainConfig(**JVP)
    jstate = jwgan.init_train_state(jax.random.PRNGKey(3), JG32, JD32, jtc)
    real, labels = ts._batch(3, seed=31)
    real = real.astype(np.float32)
    _, kz, keps, _, _, _ = jax.random.split(jstate["rng"], 6)
    z = jax.random.normal(kz, (ts.B, JG32.z_dim), jnp.float32)
    eps = jax.random.uniform(keps, (ts.B, 1, 1, 1), jnp.float32)
    tc = twgan.TrainConfig(**JVP)
    tstate = twgan.train_state_from_jax(TG32, TD32, tc,
                                        jax.device_get(jstate), "cpu")
    jnew, jm = jwgan.make_train_step(JG32, JD32, jtc, step=3, fading=False,
                                     donate=False)(
        jstate, jnp.asarray(real), jnp.asarray(labels), jnp.float32(1.0))
    tnew, tm = twgan.make_train_step(TG32, TD32, tc, step=3, fading=False)(
        tstate, torch.from_numpy(real), torch.from_numpy(labels), 1.0,
        z=torch.from_numpy(np.array(z)), eps=torch.from_numpy(np.array(eps)))
    assert calls["jvp"] > 0
    for k in twgan.METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    jnew = jax.device_get(jnew)
    for opt in ("opt_d", "opt_g"):
        want = ts._flat(jnew[opt][0].mu)
        for n, w in want.items():
            got = tnew[opt]["mu"][n].numpy()
            assert got.dtype == np.float32
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got - w).max()) <= 1e-4 * scale, (opt, n)


def _epilogue_calls(monkeypatch):
    calls = {"fwd": 0, "bwd": 0, "bwd2": 0, "jvp": 0}
    for name, attr in (("fwd", "bias_pixelnorm_lrelu_ref"),
                       ("bwd", "bias_pixelnorm_lrelu_backward_ref"),
                       ("bwd2", "second_order_ref"),
                       ("jvp", "bias_pixelnorm_lrelu_jvp_ref")):
        def counted(*a, _fn=getattr(E, attr), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(E, attr, counted)
    return calls


@pytest.mark.parametrize("mode", ["reverse", "jvp"])
def test_penalty_iteration_runs_the_kernel_functions(monkeypatch, mode):
    """What a card iteration launches, counted on the CPU through the
    kernels' plain versions (each Function calls its own once per use):
    with n the A calls of one D forward (A on every D conv here, none in
    this G), a jvp penalty iteration runs n tangents, n second derivatives
    and 4n + n + n backwards (four first-order passes, the tangent's
    transpose and the dual forward's primal chain, whose last A the
    conditional head's tangent reads); a reverse one no tangent and
    4n + (n - 1) backwards (its outer pass skips the last A).  Neither runs
    torch's own double backward of a conv."""
    calls = _epilogue_calls(monkeypatch)
    state = twgan.init_train_state(TG32, TD32, twgan.TrainConfig(), seed=0,
                                   device="cpu")
    real = torch.from_numpy(_rand((ts.B, 16, 16, 3), 8))
    labels = torch.from_numpy(np.arange(ts.B) % ts.NUM_CLASSES)
    with torch.no_grad():
        state["d"](real, labels, step=3)
    n = calls["fwd"]
    assert n == 6
    calls.update(fwd=0, bwd=0, bwd2=0, jvp=0)
    z, eps = twgan.draw_z_eps(TG32, ts.B, torch.Generator().manual_seed(0))
    step = twgan.make_train_step(TG32, TD32, twgan.TrainConfig(gp_mode=mode),
                                 step=3, fading=False)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, real, labels, 1.0, z=z, eps=eps)
    names = {e.key for e in prof.key_averages()}
    assert "aten::_convolution_double_backward" not in names
    if mode == "jvp":
        assert calls == {"fwd": 5 * n, "bwd": 4 * n + n + n,
                         "bwd2": n, "jvp": n}
    else:   # the outer pass: all but the last A again, and its 2nd order
        assert calls == {"fwd": 4 * n, "bwd": 4 * n + n - 1, "bwd2": n,
                         "jvp": 0}
