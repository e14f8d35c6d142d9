"""pgx_torch's training loop against pgx's ``train_loop`` on the CPU.

The tiny conditional "proper" pair of tests/test_torch_train_step.py
(channel 8, z_dim 8, 3 classes), compute dtype float64 in both packages
(master weights float32, as both loops keep them), batch 4, the images-seen
schedule ``ProperSchedule(8, 4, max_step=3, init_step=2)``: 8px for
iterations 0-3 (fading 0-1), 16px for 4-7 (fading 4-5).

pgx's loop writes a trial of 2 iterations without full state.  pgx resumes
one copy and the port another, model-only, for the 6 iterations that
cross the 8px -> 16px switch.  Both start from the same npz pair with fresh
Adam, read the same numpy batch stream (tests/test_torch_data.py holds the
streams equal bit for bit) and draw z and eps from pgx's key chain: the
port's ``draws=`` replays ``jax.random.split(rng, 6)`` per iteration from
the key pgx's model-only resume starts with.

Tolerances.  The first resumed iteration's metrics: 1e-5 relative (the D
step reads only the loaded weights; measured 1.4e-9 on g_loss, which reads
D after one Adam step, 3e-15 elsewhere).  Later iterations: 1e-4 of
max(|value|, 1).  Both loops compute in float64 but keep float32 master
weights and run Adam in float32, where the two packages' update expressions
round differently in the last bit, and that ulp-level difference then
propagates through the ill-conditioned penalty; measured up to 3e-7
relative over the 6 iterations, so the bound leaves a 300x margin while a
wrong alpha, batch or draw moves the metrics by 1e-2 or more.  The CSV
holds the same values printed to 5 decimals: 1e-4 of max(|value|, 1) plus
1e-5 for the two roundings.  The final ``_g``/``_d`` npz: 1e-5 absolute
(measured 1.2e-6, 2.5 float32 ulps at the largest weight, 3.8).
"""

import glob
import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx import checkpoint as jckpt
from pgx.data import synthetic_dataset as jsynthetic
from pgx.models import zoo as jzoo
from pgx.train import ProperSchedule as JProperSchedule
from pgx.train import wgan as jwgan
from pgx.train.loop import LoopConfig as JLoopConfig
from pgx.train.loop import train_loop as jtrain_loop
from pgx_torch import checkpoint as tckpt
from pgx_torch.data import synthetic_dataset as tsynthetic
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import ProperSchedule as TProperSchedule
from pgx_torch.train import wgan as twgan
from pgx_torch.train.loop import LoopConfig as TLoopConfig
from pgx_torch.train.loop import train_loop as ttrain_loop

B, NUM_CLASSES, SEED = 4, 3, 0
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=4, dtype="float64")
DKW = {k: v for k, v in KW.items() if k != "z_dim"}
JG = jzoo.conditional_correct_generator(channel=8, **KW)
JD = jzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
TG = tzoo.conditional_correct_generator(channel=8, **KW)
TD = tzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
FIRST_RUN, TOTAL = 2, 8
LOOP = dict(trial_name="par", batch_size=B, sample_every=3,
            checkpoint_every=3, log_every=1, seed=SEED,
            keep_full_state=False, snapshot_sources=False, verbose=False)
FIRST_RTOL, RTOL, CSV_ATOL, NPZ_ATOL = 1e-5, 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: more intra-op threads only contend with the
    other test processes of a parallel run (a loop iteration ran 40x slower
    that way), so torch runs on one thread here and is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pgx_loop(main_path, total=None, resume_dir=None, hooks=None):
    return jtrain_loop(
        JG, JD, jwgan.TrainConfig(), JProperSchedule(8, B, 3, 2),
        jsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
        JLoopConfig(main_path=main_path, total_iterations=total,
                    use_mesh=False, **LOOP),
        resume_dir=resume_dir, hooks=hooks)


def _port_loop(main_path, total=None, resume_dir=None, hooks=None,
               draws=None):
    return ttrain_loop(
        TG, TD, twgan.TrainConfig(), TProperSchedule(8, B, 3, 2),
        tsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
        TLoopConfig(main_path=main_path, total_iterations=total, **LOOP),
        resume_dir=resume_dir, hooks=hooks, device="cpu", draws=draws)


class PgxKeyChain:
    """The draws of pgx's step, iteration by iteration: the loop's key
    ``PRNGKey(seed)`` split in three by ``init_train_state`` (its third
    part is ``state["rng"]``, which a model-only resume does not restore),
    then ``split(rng, 6)`` per iteration -> (rng, kz, keps, ...)."""

    def __init__(self, seed):
        _, _, self.rng = jax.random.split(jax.random.PRNGKey(seed), 3)

    def __call__(self, i, real):
        self.rng, kz, keps, _, _, _ = jax.random.split(self.rng, 6)
        bsz = real.shape[0]
        z = jax.random.normal(kz, (bsz, JG.z_dim), jnp.float32)
        eps = jax.random.uniform(keps, (bsz, 1, 1, 1), jnp.float32)
        return (torch.from_numpy(np.array(z)),
                torch.from_numpy(np.array(eps)), None)


def _recorder(out):
    def hook(i, st, state, metrics):
        out.append((i, st.step, st.fading,
                    {k: float(v) for k, v in metrics.items()}))
    return hook


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    """pgx's 2-iteration trial, and the port's trial of the same run."""
    root = tmp_path_factory.mktemp("loop")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        pgx_trial = _pgx_loop(str(root / "pgx"), total=FIRST_RUN)
        port_trial = _port_loop(str(root / "port"), total=FIRST_RUN)
    return root, pgx_trial, port_trial


def _csv(trial):
    (path,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [[float(v) for v in row.split(",")] for row in lines[1:]]


def _tree(trial, kind):
    return tckpt._flatten(tckpt.load_params(
        tckpt.latest_checkpoint(trial, kind)))


def test_resumed_loop_matches_pgx_through_a_stage_switch(trials):
    root, pgx_trial, _ = trials
    # copies under the trial's own name, so that both loops append to its
    # CSV
    name = os.path.basename(pgx_trial)
    pj, pt = str(root / "pgx_resumed" / name), str(root / "port_resumed" / name)
    shutil.copytree(pgx_trial, pj)
    shutil.copytree(pgx_trial, pt)
    jm, tm = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no drift
        _pgx_loop(str(root), resume_dir=pj,
                  hooks={"on_iteration": _recorder(jm)})
        _port_loop(str(root), resume_dir=pt, draws=PgxKeyChain(SEED),
                   hooks={"on_iteration": _recorder(tm)})
    assert [r[:3] for r in tm] == [r[:3] for r in jm] == [
        (2, 2, False), (3, 2, False), (4, 3, True), (5, 3, True),
        (6, 3, False), (7, 3, False)]
    for n, ((i, _, _, want), (_, _, _, got)) in enumerate(zip(jm, tm)):
        assert got.keys() == want.keys()
        for k in want:
            tol = (FIRST_RTOL * abs(want[k]) if n == 0
                   else RTOL * max(abs(want[k]), 1.0))
            assert abs(got[k] - want[k]) <= tol, (
                f"iteration {i}: {k} {got[k]!r} vs pgx {want[k]!r}")
    jhead, jrows = _csv(pj)
    thead, trows = _csv(pt)
    assert thead == jhead == "iter,g,d,grad,alpha"
    assert len(trows) == len(jrows) == FIRST_RUN + 6
    for got, want in zip(trows, jrows):
        assert got[0] == want[0] and got[4] == want[4]      # iter, alpha
        for g, w in zip(got[1:4], want[1:4]):
            assert abs(g - w) <= RTOL * max(abs(w), 1.0) + CSV_ATOL, (
                got, want)
    for kind in ("g", "d"):
        assert os.path.basename(tckpt.latest_checkpoint(pt, kind)) == (
            f"{TOTAL:03d}_{kind}.model")
        got, want = _tree(pt, kind), _tree(pj, kind)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=NPZ_ATOL, err_msg=k)


def _layout(trial):
    out = []
    for dirpath, _, names in os.walk(trial):
        rel = os.path.relpath(dirpath, trial)
        out += [os.path.normpath(os.path.join(rel, n)) for n in names]
    return sorted(out)


def test_trial_structure_matches_pgx(trials):
    _, pgx_trial, port_trial = trials
    jpost = os.path.basename(pgx_trial)[len("trial_"):]
    tpost = os.path.basename(port_trial)[len("trial_"):]
    assert jpost.startswith("par_") and tpost.startswith("par_")
    rename = lambda names, post: [n.replace(post, "POSTFIX") for n in names]
    assert rename(_layout(port_trial), tpost) == rename(
        _layout(pgx_trial), jpost) == [
            "checkpoint/001_d.model", "checkpoint/001_g.model",
            "checkpoint/002_d.model", "checkpoint/002_g.model",
            "sample/001.png", "timing.json", "train_config_POSTFIX.json",
            "train_log_POSTFIX.txt"]
    jhead, jrows = _csv(pgx_trial)
    thead, trows = _csv(port_trial)
    assert thead == jhead
    assert [(r[0], r[4]) for r in trows] == [(r[0], r[4]) for r in jrows]
    with open(os.path.join(port_trial, "timing.json")) as f:
        ttiming = json.load(f)
    with open(os.path.join(pgx_trial, "timing.json")) as f:
        jtiming = json.load(f)
    assert ttiming.keys() == jtiming.keys() == {"1", "2"}
    for k in jtiming:
        assert ttiming[k].keys() == jtiming[k].keys()
        assert ttiming[k]["resolution"] == jtiming[k]["resolution"] == 8
    tcfg, jcfg = tckpt.load_config(port_trial), jckpt.load_config(pgx_trial)
    assert tcfg == jcfg      # every key and value, the schedule included
    # the sample grid: 3 x 3 tiles of 8px with 2px padding
    with open(os.path.join(port_trial, "sample", "001.png"), "rb") as f:
        png = f.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 3 * (8 + 2) + 2


def test_pgx_resumes_a_port_trial(trials):
    root, _, port_trial = trials
    resumed = str(root / "port_for_pgx")
    shutil.copytree(port_trial, resumed)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # configs agree
        _pgx_loop(str(root), total=FIRST_RUN + 1, resume_dir=resumed,
                  hooks={"on_iteration": _recorder(seen)})
    assert [r[:3] for r in seen] == [(2, 2, False)]
    assert all(np.isfinite(v) for v in seen[0][3].values())
    # pgx loaded the port's EMA generator into its G: its first resumed
    # D step scores the port's fakes, so the file it writes differs from
    # the one it read only by that iteration's update
    grown = jckpt.load_params(jckpt.latest_checkpoint(resumed, "g"))
    assert jckpt.checkpoint_iteration(
        jckpt.latest_checkpoint(resumed, "g")) == FIRST_RUN + 1
    start = _tree(port_trial, "g")
    end = tckpt._flatten(jax.device_get(grown))
    assert start.keys() == end.keys()
    assert 0 < max(float(np.abs(end[k] - start[k]).max())
                   for k in start) < 1e-2
