"""pgx_torch.eval.sweep against pgx.eval.sweep on the CPU.

The tiny conditional "proper" generator (channel 8, z_dim 8, 3 classes,
16px) with pgx's own initial parameters, carried into the port.  Both
packages get one random Inception weights file
(tests/torch_fid_inception.py's ``randomize_``).  In the comparisons the
features are cut to their first 64 of 2048 dimensions in both packages
(a wrapper around each extractor): scipy's ``sqrtm`` of a 2048 x 2048
product takes ~12 s on a CPU, of 64 x 64 a few ms, and the chain under
test (sampling, preprocessing, Inception, statistics, the score files) is
the same; the CLI case cuts its extractor the same way.

Tolerances.  Samples: labels exact, images 1e-5 absolute (f32 generators
that sum in other orders; measured ~1e-7).  Scores: 1e-3 relative, pgx's
own bound between its JAX and torch stacks (f32 convolutions in other
orders move the features by ~1e-6 relative, and a sample within an ulp of
a truncation edge flips one byte).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from pgx import checkpoint as jckpt
from pgx.data import synthetic_dataset as jsynthetic
from pgx.eval import fid as jfid
from pgx.eval import inception as jinc
from pgx.eval import sweep as jsweep
from pgx.models import init_generator as jinit_generator
from pgx.models import zoo as jzoo
from pgx.train import ProperSchedule as JProperSchedule
from pgx.train.schedule import schedule_to_dict as jschedule_to_dict
from pgx.train.wgan import TrainConfig as JTrainConfig
from pgx_torch.data import synthetic_dataset as tsynthetic
from pgx_torch.eval import fid as tfid
from pgx_torch.eval import inception as tinc
from pgx_torch.eval import sweep as tsweep
from pgx_torch.models import Generator
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import ProperSchedule as TProperSchedule

K = 64                       # feature dimensions kept in the comparisons
BATCH = 4                    # one batch shape: one compile of pgx's jit
RTOL = 1e-3
KW = dict(z_dim=8, num_classes=3, channel=8, max_step=3)
JG = jzoo.conditional_correct_generator(**KW)
JD = jzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, num_classes=3, max_step=3)
TG = tzoo.conditional_correct_generator(**KW)
ITERS = (40, 60)             # both past the schedule's end: step 3, 16px


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel test run every worker's torch would take every
    core; one intra-op thread each keeps them from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Cut:
    """The first K feature dimensions of ``extractor``."""

    def __init__(self, extractor):
        self.extractor = extractor
        self.device = getattr(extractor, "device", "cpu")

    def __call__(self, batch):
        return np.asarray(self.extractor(batch))[:, :K]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    from tests.torch_fid_inception import FIDInceptionV3, randomize_
    path = str(root / "rand_inception.pt")
    torch.save(randomize_(FIDInceptionV3(), seed=11).state_dict(), path)
    jext = _Cut(jfid.make_extractor(jinc.load_torch_weights(path)))
    text = _Cut(tfid.make_extractor(tinc.load_torch_weights(path),
                                    device="cpu"))
    params = jax.tree.map(np.asarray,
                          jinit_generator(jax.random.PRNGKey(3), JG))
    return root, path, jext, text, params


def _pgx_trial(root, params):
    """A trial as pgx's checkpoint module writes it: its config with the
    schedule block and the G checkpoints at ITERS."""
    trial = str(root / "trial")
    if os.path.isdir(trial):
        return trial
    jckpt.save_config(trial, JG, JD, JTrainConfig(),
                      extra={"schedule": jschedule_to_dict(
                          JProperSchedule(8, 4, 3, 2))}, postfix="t")
    os.makedirs(os.path.join(trial, "checkpoint"))
    for n, it in enumerate(ITERS):
        scaled = jax.tree.map(lambda a: a * (1.0 + 0.25 * n), params)
        jckpt.save_params(os.path.join(trial, "checkpoint",
                                       jckpt.checkpoint_name(it, "g")),
                          scaled)
    return trial


def _spy(gen, seen):
    def run(g, z, labels, alpha):
        seen.append((np.asarray(z).copy(), np.asarray(labels).copy(),
                     float(alpha)))
        return gen(g, z, labels, alpha)
    return run


def test_generate_samples_equals_pgx(setup):
    _, _, _, _, params = setup
    from pgx.train.wgan import make_eval_generate as jmake
    from pgx_torch.train.wgan import make_eval_generate as tmake
    kw = dict(step=3, alpha=0.37, fading=True, num_samples=10,
              batch_size=BATCH, seed=5, num_classes=3)
    jseen, tseen = [], []
    want = jsweep.generate_samples(
        params, JG, gen=_spy(jmake(JG, step=3, fading=True), jseen), **kw)
    got = tsweep.generate_samples(
        Generator.from_jax_params(TG, params, "cpu"), TG,
        gen=_spy(tmake(TG, step=3, fading=True), tseen), **kw)
    assert got.shape == want.shape == (10, 16, 16, 3)
    assert got.dtype == np.float32
    assert [len(s[0]) for s in tseen] == [4, 4, 2]
    for (jz, jl, ja), (tz, tl, ta) in zip(jseen, tseen):
        np.testing.assert_array_equal(tz, jz)
        np.testing.assert_array_equal(tl, jl)
        assert ta == ja
    labels = np.concatenate([s[1] for s in tseen])
    assert sorted(np.bincount(labels)) == [3, 3, 4]      # class-balanced
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _scores(trial):
    out = {}
    for name in ("fid_score.json", "kid_score.json", "fid_score_meta.json"):
        p = os.path.join(trial, name)
        out[name] = json.load(open(p)) if os.path.exists(p) else None
    return out


def _close(got, want):
    assert abs(got - want) <= RTOL * max(abs(want), 1e-6), (got, want)


def test_sweep_trial_on_a_pgx_trial_equals_pgx(setup, capsys):
    """Both packages sweep copies of one pgx-written trial in which the
    first checkpoint holds an in-training score (marked in the meta file)
    and a marked score without a checkpoint file is left over: the first
    is scored again and unmarked, the leftover stays, both with KID; the
    score files agree; a second sweep scores nothing."""
    root, _, jext, text, params = setup
    trial = _pgx_trial(root, params)
    first = jckpt.checkpoint_name(ITERS[0], "g")
    real = tsynthetic(8, 32, 3, 3, seed=1).at_resolution(16)
    copies = {}
    for pkg in ("pgx", "port"):
        copies[pkg] = str(root / f"sweep_{pkg}")
        shutil.copytree(trial, copies[pkg])
        for name, score in ((first, 1.5), ("010_g.model", 2.5)):
            jsweep.append_fid_score(copies[pkg], name, score)
            jsweep._append_score(copies[pkg], "fid_score_meta.json", name,
                                 "in-training")
    kw = dict(num_samples=8, batch_size=BATCH, kid=True, kid_subset_size=6,
              kid_subsets=3)
    sched = JProperSchedule(8, 4, 3, 2)
    want = jsweep.sweep_trial(copies["pgx"], sched, real, extractor=jext,
                              **kw)
    got = tsweep.sweep_trial(copies["port"], TProperSchedule(8, 4, 3, 2),
                             real, extractor=text, device="cpu", **kw)
    out = capsys.readouterr().out
    assert "(re-scored)" in out and "keep their per-stage baseline" in out
    assert got.keys() == want.keys() == {first, "010_g.model",
                                         jckpt.checkpoint_name(ITERS[1],
                                                               "g")}
    sj, st = _scores(copies["pgx"]), _scores(copies["port"])
    assert st["fid_score_meta.json"] == sj["fid_score_meta.json"] == {
        "010_g.model": "in-training"}
    assert st["fid_score.json"]["010_g.model"] == 2.5
    assert st["fid_score.json"][first] != 1.5
    for name, w in sj["fid_score.json"].items():
        _close(st["fid_score.json"][name], w)
    assert st["kid_score.json"].keys() == sj["kid_score.json"].keys()
    for name, (wm, ws) in sj["kid_score.json"].items():
        tm, ts = st["kid_score.json"][name]
        _close(tm, wm)
        _close(ts, ws)
    # a second pass scores nothing: the files stay as they are
    again = tsweep.sweep_trial(copies["port"], TProperSchedule(8, 4, 3, 2),
                               real, extractor=text, device="cpu",
                               verbose=False, **kw)
    assert again == got and _scores(copies["port"]) == st


def test_real_statistics_equal_pgx(setup):
    """``precompute_real_statistics`` over class-balanced subsets per size,
    each package reading the other's files."""
    root, _, jext, text, _ = setup
    kw = dict(samples_per_size=8, batch_size=BATCH, seed=2, prefix="r")
    jsweep.precompute_real_statistics(jsynthetic(24, 32, 3, 3, seed=4),
                                      (8, 32), str(root / "jstats"),
                                      extractor=jext, **kw)
    tsweep.precompute_real_statistics(tsynthetic(24, 32, 3, 3, seed=4),
                                      (8, 32), str(root / "tstats"),
                                      extractor=text, **kw)
    for size in (8, 32):
        tmu, tsig = tsweep.load_real_statistics(str(root / "tstats"), size,
                                                prefix="r")
        jmu, jsig = tsweep.load_real_statistics(str(root / "jstats"), size,
                                                prefix="r")
        np.testing.assert_array_equal(
            jsweep.load_real_statistics(str(root / "tstats"), size, "r")[0],
            tmu)
        assert tmu.shape == (K,) and tsig.shape == (K, K)
        scale = np.abs(jsig).max()
        np.testing.assert_allclose(tmu, jmu, rtol=0,
                                   atol=RTOL * np.abs(jmu).max())
        np.testing.assert_allclose(tsig, jsig, rtol=0, atol=RTOL * scale)


def test_training_fid_equals_pgx(setup):
    """``TrainingFid.score`` at a growth state: the same FID as pgx's, the
    entry in fid_score.json, "in-training" in the meta file, the real
    statistics cached per resolution and the sampling function taken from
    the shared cache."""
    root, _, jext, text, params = setup
    from pgx.train.schedule import ScheduleState as JState
    from pgx_torch.train.schedule import ScheduleState as TState
    kw = dict(num_samples=8, batch_size=BATCH, max_real=8, seed=1)
    jfid_ = jsweep.TrainingFid(jsynthetic(16, 32, 3, 3, seed=6), JG,
                               extractor=jext, **kw)
    cache = {}
    tfid_ = tsweep.TrainingFid(tsynthetic(16, 32, 3, 3, seed=6), TG,
                               extractor=text, gen_cache=cache, **kw)
    dirs = {p: str(root / f"tfid_{p}") for p in ("pgx", "port")}
    for d in dirs.values():
        os.makedirs(d)
    want = jfid_.score(dirs["pgx"], 7, params, JState(3, 0.5, True, 16,
                                                      False))
    gen = Generator.from_jax_params(TG, params, "cpu")
    got = tfid_.score(dirs["port"], 7, gen, TState(3, 0.5, True, 16, False))
    _close(got, want)
    assert set(cache) == {(3, True)} and set(tfid_._real_stats) == {16}
    st = _scores(dirs["port"])
    assert st["fid_score.json"] == {"007_g.model": got}
    assert st["fid_score_meta.json"] == {"007_g.model": "in-training"}
    assert tfid_.score(None, 8, gen, TState(3, 0.5, True, 16, False)) == got
    with pytest.raises(TypeError, match="array-backed"):
        tsweep.TrainingFid(object(), TG, extractor=text)


def test_fid_sweep_cli(setup, capsys, monkeypatch):
    """``pgx_torch.cli.fid_sweep`` on a pgx-written trial with the weights
    file, KID on: the files, the best-of line, the comparable /
    in-training split, and ``--data-parallel 2`` refused."""
    from pgx_torch.cli import fid_sweep
    monkeypatch.setattr(fid_sweep, "make_extractor", lambda *a, **k: _Cut(
        tfid.make_extractor(*a, **k)))
    root, path, _, _, params = setup
    trial = str(root / "cli")
    shutil.copytree(_pgx_trial(root, params), trial)
    os.remove(os.path.join(trial, "checkpoint",
                           jckpt.checkpoint_name(ITERS[0], "g")))
    jsweep.append_fid_score(trial, "005_g.model", 3.0)
    jsweep._append_score(trial, "fid_score_meta.json", "005_g.model",
                         "in-training")
    args = ["--trial", trial, "--num-samples", "8", "--num-real", "8",
            "--batch-size", str(BATCH), "--kid", "--kid-subset-size", "6",
            "--kid-subsets", "3", "--inception-weights", path, "--device",
            "cpu"]
    out = fid_sweep.main(args)
    name = jckpt.checkpoint_name(ITERS[1], "g")
    assert set(out["comparable"]) == {name}
    assert out["in_training"] == {"005_g.model": 3.0}
    printed = capsys.readouterr().out
    assert f"best: {name}" in printed and "excluded from best" in printed
    st = _scores(trial)
    assert np.isfinite(st["fid_score.json"][name])
    assert np.isfinite(st["kid_score.json"][name][0])
    with pytest.raises(NotImplementedError, match="item 5"):
        fid_sweep.main(args + ["--data-parallel", "2"])
