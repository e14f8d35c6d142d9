"""The multi-step window (``make_train_multi_step``) and the loop's
``steps_per_call`` against pgx on the CPU.

A window of k iterations is the single step's body k times with the
penalty on the first of each ``gp_every`` group, so it equals k single
steps bit for bit on the same draws (a generator's numbers consumed in the
same order).  Against pgx's scanned ``make_train_multi_step`` the window
is held in f64 at 1e-9 with pgx's draws replayed (the tolerances of
``tests/test_torch_train_step.py``; the metrics are sums over the window).
``_scan_window`` and ``_auto_k`` give pgx's answers on a grid, pgx's nested
``_auto_k`` read from its source.  A loop with ``steps_per_call=4`` and
``gp_every=2`` is held against pgx's loop through a resolution switch: its
CSV rows (5 decimals) within 1e-6, the final npz at the 1e-5 of
``tests/test_torch_loop_parity.py`` (f32 master weights and Adam in both
loops).  A SIGINT inside a window lands at its end and
the resumed run ends bit for bit where an uninterrupted one does.
"""

import ast
import glob
import os
import shutil
import signal
import textwrap
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.data import synthetic_dataset as jsynthetic
from pgx.train import ProperSchedule as JProperSchedule
from pgx.train import loop as jloop
from pgx.train import wgan as jwgan
from pgx_torch.augment import AdaConfig, bgc_config
from pgx_torch.data import synthetic_dataset as tsynthetic
from pgx_torch.train import ProperSchedule as TProperSchedule
from pgx_torch.train import loop as tloop
from pgx_torch.train import wgan as twgan
from tests import test_torch_loop_parity as lp
from tests import test_torch_train_step as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, as the other loop tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(k, step, seed):
    out = [ts._batch(step, seed + j) for j in range(k)]
    return ([torch.from_numpy(r) for r, _ in out],
            [torch.from_numpy(lab) for _, lab in out])


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "ada_fused"])
def test_window_equals_k_single_steps(variant):
    """k = 4, gp_every = 2, the fading phase (alpha moves inside the
    window): the state and the summed metrics of one window equal those of
    4 single steps bit for bit, the draws taken from one generator in the
    same order (with ADA the pipe draws lazily inside each step)."""
    tc = twgan.TrainConfig(gp_every=2, fused_g=variant == "ada_fused")
    aug = (dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig())
           if variant == "ada_fused" else {})
    jstate = jax.device_get(ts._initial_state(0))
    reals, labels = _batches(4, 3, 40)
    alphas = [0.25, 0.5, 0.75, 1.0]

    def draws_from(gen):
        def draw(j, real):
            z, eps = twgan.draw_z_eps(ts.TG, real.shape[0], gen,
                                      dtype=real.dtype)
            return z, eps, (twgan.draw_augment_sources(gen) if aug
                            else None)
        return draw

    singles = twgan.train_state_from_jax(ts.TG, ts.TD, tc, jstate, "cpu")
    if aug:
        singles["ada"]["p"].fill_(0.6)
    draw = draws_from(torch.Generator().manual_seed(9))
    sums = None
    for j in range(4):
        z, eps, src = draw(j, reals[j])
        step = twgan.make_train_step(ts.TG, ts.TD, tc, step=3, fading=True,
                                     apply_gp=j % 2 == 0, **aug)
        singles, m = step(singles, reals[j], labels[j], alphas[j], z=z,
                          eps=eps, aug_draws=src)
        sums = m if sums is None else {n: sums[n] + v for n, v in m.items()}

    window = twgan.train_state_from_jax(ts.TG, ts.TD, tc, jstate, "cpu")
    if aug:
        window["ada"]["p"].fill_(0.6)
    fn = twgan.make_train_multi_step(ts.TG, ts.TD, tc, step=3, fading=True,
                                     k=4, **aug)
    window, wsums = fn(window, reals, labels, alphas,
                       draws=draws_from(torch.Generator().manual_seed(9)))
    assert wsums.keys() == sums.keys()
    for n in sums:
        assert torch.equal(wsums[n], sums[n]), n
    assert window["iteration"] == singles["iteration"] == 4
    for net in ("g", "d", "g_ema"):
        for (n, p), q in zip(window[net].named_parameters(),
                             singles[net].parameters()):
            assert torch.equal(p, q), f"{net}.{n}"
    for opt in ("opt_g", "opt_d"):
        assert window[opt]["count"] == singles[opt]["count"] == 4
        for moment in ("mu", "nu"):
            for n, v in window[opt][moment].items():
                assert torch.equal(v, singles[opt][moment][n]), n
    for n, v in window["ada"].items():
        assert torch.equal(v, singles["ada"][n]), n


def test_window_matches_pgx_multi_step():
    """pgx's scanned window (k = 4, gp_every = 2) against the port's, f64,
    pgx's key chain replayed per iteration: the summed metrics, gradients,
    moments, parameters and EMA at the tolerances of the single step."""
    k, tc_kw = 4, dict(gp_every=2)
    jstate = ts._initial_state(1)
    tstate = twgan.train_state_from_jax(ts.TG, ts.TD,
                                        twgan.TrainConfig(**tc_kw),
                                        jax.device_get(jstate), "cpu")
    reals, labels = _batches(k, 3, 50)
    # pgx's window takes its alphas as f32, as its loop hands them over
    alphas = np.asarray([0.2, 0.4, 0.6, 0.8], np.float32)
    rng = [jstate["rng"]]

    def pgx_draws(j, real):
        rng[0], kz, keps, _, _, _ = jax.random.split(rng[0], 6)
        z = jax.random.normal(kz, (ts.B, ts.JG.z_dim), jnp.float32)
        eps = jax.random.uniform(keps, (ts.B, 1, 1, 1), jnp.float64)
        return (torch.from_numpy(np.array(z)),
                torch.from_numpy(np.array(eps)), None)

    tfn = twgan.make_train_multi_step(ts.TG, ts.TD,
                                      twgan.TrainConfig(**tc_kw), step=3,
                                      fading=True, k=k)
    tstate, tm = tfn(tstate, reals, labels, [float(a) for a in alphas],
                     draws=pgx_draws)
    jfn = jwgan.make_train_multi_step(ts.JG, ts.JD,
                                      jwgan.TrainConfig(**tc_kw), step=3,
                                      fading=True, k=k, donate=False)
    jstate, jm = jfn(jstate, tuple(jnp.asarray(r.numpy()) for r in reals),
                     tuple(jnp.asarray(lab.numpy()) for lab in labels),
                     jnp.asarray(alphas))
    ts._compare(tstate, tm, jax.device_get(jstate), jm, "window of 4")


def test_multi_step_refuses_what_pgx_refuses():
    for kw, k in ((dict(n_critic=2), 2), (dict(gp_every=4), 6),
                  (dict(), 0)):
        for make, tc in ((twgan.make_train_multi_step, twgan.TrainConfig),
                         (jwgan.make_train_multi_step, jwgan.TrainConfig)):
            with pytest.raises(ValueError):
                make(ts.TG if make is twgan.make_train_multi_step else ts.JG,
                     ts.TD if make is twgan.make_train_multi_step else ts.JD,
                     tc(**kw), step=3, fading=False, k=k)


# ---------------------------------------------------------------------------
# The loop's rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gp_every", [1, 2, 4])
@pytest.mark.parametrize("cadence", [(1000, 1000, 500), (6, 10, 4),
                                     (3, 7, 5)])
def test_scan_window_matches_pgx(gp_every, cadence):
    """Every start i of two schedules (stage edges every 4 or 6
    iterations, a per-stage batch), windows k of 1-8, against pgx's
    ``_scan_window`` on pgx's schedule."""
    sample, ckpt, log = cadence
    tc = twgan.TrainConfig(gp_every=gp_every)
    jtc = jwgan.TrainConfig(gp_every=gp_every)
    cfg = dict(sample_every=sample, checkpoint_every=ckpt, log_every=log)
    tcfg, jcfg = tloop.LoopConfig(**cfg), jloop.LoopConfig(**cfg)
    for args in ((16, 4, 4, 1, None), (24, 4, 3, 2, {3: 8})):
        tsched, jsched = TProperSchedule(*args), JProperSchedule(*args)
        total = tsched.total_iterations(0)
        assert total == jsched.total_iterations(0)
        for i in range(total):
            tst, jst = tsched.state_at(i), jsched.state_at(i)
            for k in range(1, 9):
                assert tloop._scan_window(i, tst, tsched, total, tc, tcfg,
                                          k) == jloop._scan_window(
                    i, jst, jsched, total, jtc, jcfg, k), (args, i, k)


def _pgx_auto_k():
    """pgx's ``_auto_k``, a closure inside its ``train_loop``, compiled
    from pgx's own source with ``tc`` as a free name."""
    with open(jloop.__file__) as f:
        tree = ast.parse(f.read())
    loop_fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name == "train_loop")
    node = next(n for n in ast.walk(loop_fn)
                if isinstance(n, ast.FunctionDef) and n.name == "_auto_k")
    src = textwrap.dedent(ast.get_source_segment(
        open(jloop.__file__).read(), node))

    def make(gp_every):
        scope = {"tc": jwgan.TrainConfig(gp_every=gp_every)}
        exec(src, scope)
        return scope["_auto_k"]
    return make


def test_auto_k_matches_pgx():
    make = _pgx_auto_k()
    for gp_every in (1, 2, 3, 4, 8, 16):
        ref = make(gp_every)
        for ms in (0.05, 1.0, 7.5, 19.99, 20.0, 35.0, 59.9, 60.0, 120.0,
                   400.0, 700.0, 5000.0):
            assert tloop._auto_k(ms, gp_every) == ref(ms), (ms, gp_every)


# ---------------------------------------------------------------------------
# The loop with windows against pgx's loop
# ---------------------------------------------------------------------------

# 4 iterations a phase (16 images, batch 4): 8px fade 0-3, stable 4-7,
# 16px fade 8-11, stable 12-15; events every 4 iterations
WLOOP = dict(lp.LOOP, sample_every=4, checkpoint_every=4, log_every=4,
             steps_per_call=4)
WTC = dict(gp_every=2)


def _windows_counted(monkeypatch):
    made = []
    orig = tloop.make_train_multi_step

    def make(*a, **kw):
        fn = orig(*a, **kw)

        def run(state, *ra, **rkw):
            made.append((kw["step"], kw["fading"], int(state["iteration"])))
            return fn(state, *ra, **rkw)
        return run
    monkeypatch.setattr(tloop, "make_train_multi_step", make)
    return made


def test_loop_with_windows_matches_pgx(tmp_path, monkeypatch):
    """pgx writes a one-iteration trial; pgx and the port resume copies of
    it model-only to iteration 16 with ``steps_per_call=4`` and
    ``gp_every=2``: single steps at 1-3, then windows at 4, 8 and 12 in
    both.  CSV rows within 1e-6, the final npz as in the loop's parity
    test."""
    sched = (16, lp.B, 3, 2)
    jcfg = lambda **kw: jloop.LoopConfig(use_mesh=False, **dict(WLOOP, **kw))
    first = jloop.train_loop(
        lp.JG, lp.JD, jwgan.TrainConfig(**WTC), JProperSchedule(*sched),
        jsynthetic(16, 32, 3, lp.NUM_CLASSES, seed=lp.SEED),
        jcfg(main_path=str(tmp_path / "pgx"), total_iterations=1))
    name = os.path.basename(first)
    pj = str(tmp_path / "pgx_resumed" / name)
    pt = str(tmp_path / "port_resumed" / name)
    shutil.copytree(first, pj)
    shutil.copytree(first, pt)
    made = _windows_counted(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        jloop.train_loop(
            lp.JG, lp.JD, jwgan.TrainConfig(**WTC), JProperSchedule(*sched),
            jsynthetic(16, 32, 3, lp.NUM_CLASSES, seed=lp.SEED),
            jcfg(main_path=str(tmp_path)), resume_dir=pj)
        tloop.train_loop(
            lp.TG, lp.TD, twgan.TrainConfig(**WTC), TProperSchedule(*sched),
            tsynthetic(16, 32, 3, lp.NUM_CLASSES, seed=lp.SEED),
            tloop.LoopConfig(main_path=str(tmp_path), **WLOOP),
            resume_dir=pt, device="cpu", draws=lp.PgxKeyChain(lp.SEED))
    assert made == [(2, False, 4), (3, True, 8), (3, False, 12)]
    jhead, jrows = lp._csv(pj)
    thead, trows = lp._csv(pt)
    assert thead == jhead
    assert [r[0] for r in trows] == [r[0] for r in jrows] == [4, 8, 12, 16]
    for got, want in zip(trows, jrows):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for kind in ("g", "d"):
        got, want = lp._tree(pt, kind), lp._tree(pj, kind)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=lp.NPZ_ATOL, err_msg=k)


def _port_loop(main_path, resume_dir=None, draws=None, **kw):
    return tloop.train_loop(
        lp.TG, lp.TD, twgan.TrainConfig(**WTC), TProperSchedule(16, lp.B, 3, 2),
        tsynthetic(16, 32, 3, lp.NUM_CLASSES, seed=lp.SEED),
        tloop.LoopConfig(main_path=str(main_path), **dict(
            WLOOP, keep_full_state=True, **kw)),
        resume_dir=resume_dir, device="cpu", draws=draws)


def _seeded_draws(stop_at=None):
    """Iteration i's draws from a generator seeded with i (the same in any
    run); SIGINT to this process when iteration ``stop_at`` draws, i.e.
    inside a window."""
    def draws(i, real):
        if i == stop_at:
            os.kill(os.getpid(), signal.SIGINT)
        gen = torch.Generator().manual_seed(1000 + i)
        z, eps = twgan.draw_z_eps(lp.TG, real.shape[0], gen, real.dtype)
        return z, eps, None
    return draws


def test_sigint_inside_a_window_resumes_bitwise(tmp_path, monkeypatch,
                                                capsys):
    """SIGINT as iteration 5 draws (window 4-7) lands at the window's end:
    the emergency checkpoint holds the state after iteration 7, and the
    resumed run ends where an uninterrupted one (other windows: 4, 8, 12)
    does, bit for bit.  A misaligned steps_per_call is rounded to a
    multiple of gp_every."""
    straight = _port_loop(tmp_path / "straight", draws=_seeded_draws(),
                          steps_per_call=3)
    assert "steps_per_call=3 is not a multiple of gp_every=2; using 4" in \
        capsys.readouterr().out
    made = _windows_counted(monkeypatch)
    prev = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        _port_loop(tmp_path / "cut", draws=_seeded_draws(stop_at=5))
    assert signal.getsignal(signal.SIGINT) == prev
    assert made == [(2, False, 4)]
    (trial,) = glob.glob(str(tmp_path / "cut" / "trial_*"))
    saved = torch.load(os.path.join(trial, "checkpoint", "008_state.pt"),
                       weights_only=True)
    assert saved["iteration"] == 8 and saved["opt_d"]["count"] == 8
    _port_loop(tmp_path / "cut", resume_dir=trial, draws=_seeded_draws())
    # the resumed run's first iteration runs alone (its events), 9-11 then
    # cannot fill an aligned window before the stage ends
    assert made[1:] == [(3, False, 12)]
    end = lambda t: torch.load(os.path.join(t, "checkpoint", "016_state.pt"),
                               weights_only=True)
    from tests.test_torch_loop import _assert_states_equal
    _assert_states_equal(end(trial), end(straight))
