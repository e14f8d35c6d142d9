"""The in-training FID of pgx_torch's loop against pgx's loop, and the
port's ``fid_selftest`` CLI, on the CPU.

Loop.  The tiny conditional "proper" pair (channel 8, z_dim 8, 3 classes,
float32, batch 4, ``ProperSchedule(8, 4, 3, 2)``): pgx's checkpoint module
writes a trial at iteration 2, and each package resumes a copy of it
(model-only, from the same npz pair) for iterations 2 and 3 at learning
rate 0, with ``fid_every=1`` and one Inception weights file.  At learning
rate 0 neither loop moves G, so both score the same EMA generator: the
printed ``"{it}; FID: ..."`` lines and the fid_score.json / meta entries
are compared, 1e-3 relative (pgx's bound between its JAX and torch
stacks).  Both packages' ``make_extractor`` are wrapped to keep the first
64 of the 2048 feature dimensions, so each tick's ``sqrtm`` takes
milliseconds instead of ~12 s on a CPU; the loop wiring under test (the
weights file, the extractor, ``TrainingFid``, the cadence, the files) is
unchanged.

Self-test.  pgx's four cases (tests/test_fid_selftest.py) on the port's
CLI with a random state dict: unrecognised weights exit 2, scoring with
``--allow-unverified``, the committed artifacts, and record -> pass ->
fail against a slot named after the file's own hash.  The chain's values
are computed once, by the CLI's own ``compute_selftest_values``, and the
CLI calls reuse them: the chain is deterministic, and each run costs a
2048 x 2048 ``sqrtm`` (~12 s on a CPU).
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
from pgx.models import init_discriminator as jinit_d
from pgx.models import init_generator as jinit_g
from pgx.models import zoo as jzoo
from pgx.train import ProperSchedule as JProperSchedule
from pgx.train import wgan as jwgan
from pgx.train.loop import LoopConfig as JLoopConfig
from pgx.train.loop import train_loop as jtrain_loop
from pgx.train.schedule import schedule_to_dict as jschedule_to_dict
from pgx_torch.cli import fid_selftest
from pgx_torch.data import synthetic_dataset as tsynthetic
from pgx_torch.data.pipeline import array_batches
from pgx_torch.eval import fid as tfid
from pgx_torch.eval import sweep as tsweep
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import ProperSchedule as TProperSchedule
from pgx_torch.train import wgan as twgan
from pgx_torch.train.loop import LoopConfig as TLoopConfig
from pgx_torch.train.loop import train_loop as ttrain_loop

K, B, NUM_CLASSES, SEED, START, TOTAL = 64, 4, 3, 0, 2, 4
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=4)
DKW = {k: v for k, v in KW.items() if k != "z_dim"}
JG = jzoo.conditional_correct_generator(channel=8, **KW)
JD = jzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
TG = tzoo.conditional_correct_generator(channel=8, **KW)
TD = tzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
LOOP = dict(trial_name="fid", batch_size=B, sample_every=100,
            checkpoint_every=100, log_every=100, seed=SEED,
            keep_full_state=False, snapshot_sources=False, fid_every=1,
            fid_samples=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel test run every worker's torch would take every
    core; one intra-op thread each keeps them from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from tests.torch_fid_inception import FIDInceptionV3, randomize_
    path = str(tmp_path_factory.mktemp("w") / "random_inception.pt")
    torch.save(randomize_(FIDInceptionV3(), seed=5).eval().state_dict(),
               path)
    return path


@pytest.fixture(scope="module")
def selftest_values(weights):
    return fid_selftest.compute_selftest_values(weights, 32, "cpu")


def _cut(make):
    def wrapped(*args, **kw):
        ext = make(*args, **kw)

        def run(batch):
            return np.asarray(ext(batch))[:, :K]
        run.device = getattr(ext, "device", "cpu")
        return run
    return wrapped


def _start_trial(root):
    """pgx's checkpoint module writes the trial both loops resume: config
    with the schedule, the npz pair at iteration START."""
    trial = str(root / "trial_fid")
    jckpt.save_config(trial, JG, JD, jwgan.TrainConfig(learning_rate=0.0),
                      extra={"batch_size": B, "seed": SEED,
                             "schedule": jschedule_to_dict(
                                 JProperSchedule(8, B, 3, 2)),
                             "augment": None}, postfix="fid")
    ck = os.path.join(trial, "checkpoint")
    os.makedirs(ck)
    g = jax.tree.map(np.asarray, jinit_g(jax.random.PRNGKey(1), JG))
    d = jax.tree.map(np.asarray, jinit_d(jax.random.PRNGKey(2), JD))
    jckpt.save_params(os.path.join(ck, jckpt.checkpoint_name(START, "g")), g)
    jckpt.save_params(os.path.join(ck, jckpt.checkpoint_name(START, "d")), d)
    return trial


def _fid_lines(out):
    return [line for line in out.splitlines() if "; FID: " in line]


def test_loop_fid_equals_pgx_loop(tmp_path, weights, monkeypatch, capsys):
    trial = _start_trial(tmp_path)
    monkeypatch.setattr(jfid, "make_extractor", _cut(jfid.make_extractor))
    monkeypatch.setattr(tfid, "make_extractor", _cut(tfid.make_extractor))
    copies = {p: str(tmp_path / p / "trial_fid") for p in ("pgx", "port")}
    for c in copies.values():
        shutil.copytree(trial, c)
    jtrain_loop(JG, JD, jwgan.TrainConfig(learning_rate=0.0),
                JProperSchedule(8, B, 3, 2),
                jsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
                JLoopConfig(main_path=str(tmp_path), total_iterations=TOTAL,
                            use_mesh=False, inception_weights=weights,
                            **LOOP), resume_dir=copies["pgx"])
    jout = _fid_lines(capsys.readouterr().out)
    ttrain_loop(TG, TD, twgan.TrainConfig(learning_rate=0.0),
                TProperSchedule(8, B, 3, 2),
                tsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
                TLoopConfig(main_path=str(tmp_path), total_iterations=TOTAL,
                            inception_weights=weights, **LOOP),
                resume_dir=copies["port"], device="cpu")
    tout = _fid_lines(capsys.readouterr().out)
    assert len(tout) == len(jout) == TOTAL - START
    for got, want in zip(tout, jout):
        (g_it, g_rest), (w_it, w_rest) = (x.split("; FID: ")
                                          for x in (got, want))
        assert g_it == w_it and g_rest.split()[1:] == w_rest.split()[1:]
        g, w = float(g_rest.split()[0]), float(w_rest.split()[0])
        assert np.isfinite(g) and abs(g - w) <= 1e-3 * abs(w) + 1e-4
    files = {}
    for p, c in copies.items():
        files[p] = [json.load(open(os.path.join(c, n)))
                    for n in ("fid_score.json", "fid_score_meta.json")]
    (tscores, tmeta), (jscores, jmeta) = files["port"], files["pgx"]
    assert tmeta == jmeta == {f"{it:03d}_g.model": "in-training"
                              for it in range(START + 1, TOTAL + 1)}
    assert tscores.keys() == jscores.keys()
    for k, w in jscores.items():
        assert abs(tscores[k] - w) <= 1e-3 * abs(w), (k, tscores[k], w)


class _NoResolutions:
    """A dataset without per-resolution arrays (as a folder dataset)."""

    def __init__(self, inner):
        self.inner = inner


def test_loop_fid_warns_and_keeps_running(tmp_path, monkeypatch):
    """A dataset without ``at_resolution`` warns once and trains without
    FID; a failing score warns and the run goes on (pgx's loop does
    both)."""
    kw = dict(main_path=str(tmp_path), total_iterations=2,
              **dict(LOOP, fid_samples=4))

    def run(dataset, **extra):
        return ttrain_loop(
            TG, TD, twgan.TrainConfig(), TProperSchedule(8, B, 3, 2),
            dataset, TLoopConfig(**kw), device="cpu", **extra)

    ds = tsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED)
    with pytest.warns(RuntimeWarning, match="array-backed"):
        trial = run(_NoResolutions(ds), batch_fn=lambda d, b, r, seed:
                    array_batches(d.inner, b, r, seed=seed))
    assert not os.path.exists(os.path.join(trial, "fid_score.json"))

    def boom(*a, **k):
        raise FloatingPointError("no square root")
    monkeypatch.setattr(tsweep.TrainingFid, "score", boom)
    with pytest.warns(RuntimeWarning, match="in-training FID failed at 1"):
        trial = run(ds)
    assert os.path.exists(os.path.join(trial, "checkpoint", "002_g.model"))


# ---------------------------------------------------------------------------
# the self-test CLI
# ---------------------------------------------------------------------------

def test_selftest_committed_artifacts():
    imgs = np.load(fid_selftest.IMAGES_PATH)["images"]
    assert imgs.shape == (64, 8, 8, 1) and imgs.dtype == np.uint8
    with open(fid_selftest.EXPECTED_PATH) as f:
        expected = json.load(f)
    slots = {k: v for k, v in expected.items() if not k.startswith("_")}
    assert slots["pt_inception-2015-12-05"]["sha256_prefix"] == "6726825d"
    assert slots["torchvision_inception_v3"]["sha256_prefix"] == "0cc3c7bd"
    assert all(v["fid_halves"] is None for v in slots.values())
    pgx_expected = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "pgx", "eval", "selftest_expected.json")
    with open(pgx_expected) as f:
        pgx_slots = {k: v for k, v in json.load(f).items()
                     if not k.startswith("_")}
    assert slots == pgx_slots


def test_selftest_unrecognised_weights_exit_2(weights, capsys):
    assert fid_selftest.main(["--weights", weights, "--device", "cpu"]) == 2
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "unrecognized_weights"
    assert out["sha256"] == fid_selftest.sha256_file(weights)


def test_selftest_allow_unverified_scores(weights, selftest_values, capsys,
                                         monkeypatch):
    monkeypatch.setattr(fid_selftest, "compute_selftest_values",
                        lambda *a, **k: dict(selftest_values))
    rc = fid_selftest.main(["--weights", weights, "--allow-unverified",
                            "--batch-size", "32", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "computed_unverified"
    assert np.isfinite(out["fid_halves"]) and out["fid_halves"] >= 0
    assert np.isfinite(out["act_mean_abs"]) and out["act_mean_abs"] > 0
    assert out["fid_halves"] == selftest_values["fid_halves"]


def test_selftest_record_then_pass_then_fail(weights, selftest_values,
                                             tmp_path, capsys, monkeypatch):
    values = selftest_values
    monkeypatch.setattr(fid_selftest, "compute_selftest_values",
                        lambda *a, **k: dict(values))
    sha = fid_selftest.sha256_file(weights)
    expected_path = str(tmp_path / "expected.json")
    with open(expected_path, "w") as f:
        json.dump({"fake-official": {"sha256_prefix": sha[:8],
                                     "fid_halves": None,
                                     "act_mean_abs": None,
                                     "act_mean": None}}, f)
    base = ["--weights", weights, "--expected", expected_path,
            "--device", "cpu"]
    assert fid_selftest.main(base) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "computed_no_expected"
    assert out["weights"] == "fake-official"
    assert fid_selftest.main(base + ["--update-expected"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == \
        "expected_recorded"
    with open(expected_path) as f:
        slot = json.load(f)["fake-official"]
    assert slot["fid_halves"] == values["fid_halves"]
    assert fid_selftest.main(base) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "pass"
    with open(expected_path, "w") as f:
        json.dump({"fake-official": dict(
            slot, act_mean_abs=slot["act_mean_abs"] * 1.5)}, f)
    assert fid_selftest.main(base) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "fail" and "act_mean_abs" in out["mismatches"]
