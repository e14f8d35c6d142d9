"""pgx_torch's training loop and its CLI on the CPU: full-state resume,
interrupts, drift warnings, refusals, the trial's source snapshot.

The tiny conditional "proper" pair (channel 8, z_dim 8, 3 classes) in
float32, batch 4, ``ProperSchedule(8, 4, max_step=3, init_step=2)``: 8px for
iterations 0-3, 16px for 4-7.  A run that stops at the stage switch
(iteration 4) and resumes from its full state must end bit for bit where an
uninterrupted run ends: the data stream restarts at the switch in both, and
the full state carries the modules, Adam, the ADA controller and the
random generator.  (Parity with pgx's loop is in
tests/test_torch_loop_parity.py.)
"""

import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from pgx.models import zoo as jzoo
from pgx_torch import checkpoint as tckpt
from pgx_torch.augment import bgc_config
from pgx_torch.cli import common as cli_common
from pgx_torch.cli import conditional_proper_cifar_train as cli
from pgx_torch.data import synthetic_dataset
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import ProperSchedule, TrainConfig
from pgx_torch.train.loop import LoopConfig, train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, NUM_CLASSES = 4, 3
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=4)
GCFG = tzoo.conditional_correct_generator(channel=8, **KW)
DCFG = tzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW.items() if k != "z_dim"})
LOOP = dict(trial_name="t", batch_size=B, sample_every=3,
            checkpoint_every=3, log_every=2, seed=1, verbose=False,
            snapshot_sources=False)
TOTAL = 8
CLI_ARGS = ["--device", "cpu", "--synthetic", "--channels", "8", "--z-dim",
            "8", "--num-classes", str(NUM_CLASSES), "--max-step", "3",
            "--init-step", "2", "--images-per-mini-step", "8",
            "--batch-size", str(B), "--sample-every", "3",
            "--checkpoint-every", "3", "--log-every", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: more intra-op threads only contend with the
    other test processes of a parallel run (a loop iteration ran 40x slower
    that way), so torch runs on one thread here and is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loop(main_path, resume_dir=None, hooks=None, gcfg=GCFG,
          schedule=None, **kw):
    loop_kw = dict(LOOP, **{k: kw.pop(k) for k in list(kw)
                            if k in LoopConfig.__dataclass_fields__})
    return train_loop(gcfg, DCFG, TrainConfig(),
                      schedule or ProperSchedule(8, B, 3, 2),
                      synthetic_dataset(16, 32, 3, NUM_CLASSES, seed=1),
                      LoopConfig(main_path=str(main_path), **loop_kw),
                      resume_dir=resume_dir, hooks=hooks, device="cpu",
                      **kw)


def _stop_at(i_stop, how):
    """on_iteration hook that interrupts after iteration ``i_stop``."""
    def hook(i, st, state, metrics):
        if i == i_stop:
            if how == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                raise KeyboardInterrupt
    return hook


@contextlib.contextmanager
def _sigint_inside_step(iteration):
    """Every step the loop makes sends SIGINT to this process as it starts
    the given iteration, i.e. while the state is being updated."""
    from pgx_torch.train import loop as loop_mod
    orig = loop_mod.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)

        def run(state, *sa, **skw):
            if state["iteration"] == iteration:
                os.kill(os.getpid(), signal.SIGINT)
            return step(state, *sa, **skw)
        return run
    loop_mod.make_train_step = make
    try:
        yield
    finally:
        loop_mod.make_train_step = orig


def _rows(trial):
    (path,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
    with open(path) as f:
        return f.read().splitlines()


def _full_state(trial, it):
    return torch.load(os.path.join(trial, "checkpoint",
                                   tckpt.state_name(it)), weights_only=True)


def _assert_states_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _loop(tmp_path_factory.mktemp("straight"))


@pytest.mark.parametrize("how", ["keyboard", "sigterm", "sigint_in_step"])
def test_interrupt_at_the_stage_switch_resumes_bitwise(tmp_path, how,
                                                       uninterrupted):
    """KeyboardInterrupt from the hook after iteration 3, SIGTERM sent
    there, or SIGINT sent while iteration 3's step updates the state (held
    until the step ends): each leaves the state after that step."""
    prev = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    with pytest.raises(SystemExit if how == "sigterm"
                       else KeyboardInterrupt) as info:
        if how == "sigint_in_step":
            with _sigint_inside_step(3):
                _loop(tmp_path)
        else:
            _loop(tmp_path, hooks={"on_iteration": _stop_at(3, how)})
    if how == "sigterm":
        assert info.value.code == 143
    # the handlers are restored
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == prev
    (trial,) = glob.glob(str(tmp_path / "trial_*"))
    # the emergency checkpoint: the state after iteration 3's step
    saved = _full_state(trial, 4)
    assert saved["iteration"] == 4 and saved["opt_d"]["count"] == 4
    assert sorted(os.listdir(os.path.join(trial, "checkpoint")))[-3:] == [
        "004_d.model", "004_g.model", "004_state.pt"]
    seen = []
    _loop(tmp_path, resume_dir=trial, hooks={
        "on_iteration": lambda i, st, state, m: seen.append(i)})
    assert seen == [4, 5, 6, 7]
    _assert_states_equal(_full_state(trial, TOTAL),
                         _full_state(uninterrupted, TOTAL))
    assert _rows(trial) == _rows(uninterrupted)


def test_full_state_resume_restores_the_generator(tmp_path):
    """Resumed mid-stage from the full state: the iteration, Adam's counts
    and the random generator continue from the file (the data stream
    restarts at the stage, as in pgx, so the run is not the straight
    one)."""
    trial = _loop(tmp_path, total_iterations=3)
    saved = _full_state(trial, 3)
    got = {}

    def hook(i, st, state, metrics):
        if not got:
            got.update(i=i, count=state["opt_g"]["count"])
    gen_states = []
    from pgx_torch.train import loop as loop_mod
    orig = loop_mod.draw_z_eps

    def spy(gcfg, batch, rng, dtype=torch.float32):
        gen_states.append(rng.get_state().clone())
        return orig(gcfg, batch, rng, dtype)
    loop_mod.draw_z_eps = spy
    try:
        _loop(tmp_path, resume_dir=trial, total_iterations=4,
              hooks={"on_iteration": hook})
    finally:
        loop_mod.draw_z_eps = orig
    assert got == {"i": 3, "count": saved["opt_g"]["count"] + 1}
    assert torch.equal(gen_states[0], saved["rng"])


def test_model_only_resume_from_the_npz_pair(tmp_path):
    trial = _loop(tmp_path, total_iterations=3, keep_full_state=False)
    assert not glob.glob(os.path.join(trial, "checkpoint", "*_state.pt"))
    g = tckpt.load_params(tckpt.latest_checkpoint(trial, "g"))
    seen = {}

    def hook(i, st, state, metrics):
        if not seen:
            seen["i"] = i
            seen["count"] = state["opt_d"]["count"]
    _loop(tmp_path, resume_dir=trial, total_iterations=4,
          keep_full_state=False, hooks={"on_iteration": hook})
    assert seen == {"i": 3, "count": 1}          # fresh Adam
    # and the EMA generator goes into both g and g_ema
    from pgx_torch.train.loop import _load_newest_state
    from pgx_torch.train.wgan import init_train_state
    state = init_train_state(GCFG, DCFG, TrainConfig(), seed=9, device="cpu")
    os.remove(tckpt.latest_checkpoint(trial, "g"))
    os.remove(tckpt.latest_checkpoint(trial, "d"))
    state, start = _load_newest_state(trial, state)
    assert start == 3 and state["iteration"] == 3
    want = tckpt._flatten(g)
    for key in ("g", "g_ema"):
        got = tckpt._flatten(tckpt.params_tree(state[key]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_resume_without_checkpoints_raises(tmp_path):
    trial = tmp_path / "trial_empty"
    os.makedirs(trial / "checkpoint")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        _loop(tmp_path, resume_dir=str(trial))


def test_resume_warns_on_drift(tmp_path):
    trial = _loop(tmp_path, total_iterations=2)
    with pytest.warns(RuntimeWarning, match="augmentation settings differ"):
        _loop(tmp_path, resume_dir=trial, total_iterations=3,
              augment_cfg=bgc_config(), augment_p=0.5)
    # the saved configs and schedule govern the resumed run
    other_g = tzoo.conditional_correct_generator(channel=8, tanh=True, **KW)
    seen = []
    with pytest.warns(RuntimeWarning) as record:
        _loop(tmp_path, resume_dir=trial, total_iterations=5, gcfg=other_g,
              schedule=ProperSchedule(16, B, 3, 2),
              hooks={"on_iteration": lambda i, st, s, m: seen.append(
                  (i, st.step, st.alpha, s["g"].cfg.tanh))})
    messages = " ".join(str(w.message) for w in record)
    assert "model configs" in messages and "growth schedule" in messages
    assert "augmentation" not in messages       # the recipe is None again
    assert seen == [(3, 2, 1.0, False), (4, 3, 0.0, False)]


@pytest.mark.parametrize("field,value", [("steps_per_call", 2),
                                         ("steps_per_call", 0),
                                         ("fid_every", 100),
                                         ("checkpoint_backend", "orbax"),
                                         ("model_parallel", 2)])
def test_loop_config_refuses_unported_options(tmp_path, field, value):
    """What is not ported raises; ``steps_per_call`` (a window of 2, or 0:
    auto) is ported and accepted, and its windows change no number: the
    loop's CSV and final state equal those of single steps.  ``fid_every``
    is ported and accepted: a run scores the EMA generator at its cadence
    into fid_score.json, marked in-training (parity with pgx's loop is in
    tests/test_torch_eval_loop.py).  ``checkpoint_backend='orbax'`` is
    ported and accepted: the loop reaches ``train_loop`` with it and keeps
    the full state in the step-indexed store, not in ``*_state.pt``.
    ``model_parallel`` is ported (channels mode): the config is accepted,
    and one process has too few ranks for a model axis of 2 (pgx's
    ``ValueError`` for too few devices, before anything trains); the
    spatial mode is accepted too, and a model axis without the
    mesh raises pgx's ``ValueError``.  Two ranks train in
    tests/test_torch_tp_loop.py."""
    if field == "model_parallel":
        assert LoopConfig(**{field: value}).model_parallel == value
        with pytest.raises(ValueError, match="model_parallel=2 does not "
                                             "divide the 1 available"):
            _loop(tmp_path, model_parallel=value)
        assert not os.listdir(tmp_path)
        assert LoopConfig(model_parallel=value,
                          model_parallel_mode="spatial"
                          ).model_parallel_mode == "spatial"
        with pytest.raises(ValueError, match="requires use_mesh"):
            LoopConfig(model_parallel=value, use_mesh=False)
        with pytest.raises(ValueError, match="unknown model_parallel_mode"):
            LoopConfig(model_parallel=value, model_parallel_mode="rows")
    elif field == "checkpoint_backend":
        assert LoopConfig(**{field: value}).checkpoint_backend == "orbax"
        trial = _loop(tmp_path, total_iterations=2, keep_full_state=True,
                      checkpoint_backend=value)
        names = os.listdir(os.path.join(trial, "checkpoint"))
        assert not any(n.endswith("_state.pt") for n in names)
        assert {"001_g.model", "002_d.model"} <= set(names)
        assert sorted(os.listdir(os.path.join(trial, "step_state"))) == [
            "1", "2"]
    elif field == "fid_every":
        assert LoopConfig(**{field: value}).fid_every == value
        trial = _loop(tmp_path, total_iterations=4, fid_every=4,
                      fid_samples=8)
        with open(os.path.join(trial, "fid_score.json")) as f:
            scores = json.load(f)
        with open(os.path.join(trial, "fid_score_meta.json")) as f:
            meta = json.load(f)
        assert sorted(scores) == ["004_g.model"]
        assert all(np.isfinite(v) for v in scores.values())
        assert meta == {k: "in-training" for k in scores}
    elif field == "steps_per_call":
        assert LoopConfig(**{field: value}).steps_per_call == value
        cadence = dict(sample_every=4, checkpoint_every=4, log_every=2)
        trials = [_loop(tmp_path / str(k), steps_per_call=k, **cadence)
                  for k in (value, 1)]
        assert _rows(trials[0]) == _rows(trials[1])
        _assert_states_equal(_full_state(trials[0], TOTAL),
                             _full_state(trials[1], TOTAL))
    else:
        with pytest.raises(NotImplementedError, match=field):
            LoopConfig(**{field: value})
    LoopConfig(use_mesh=False)
    with pytest.raises(ValueError):
        LoopConfig(checkpoint_backend="zarr")
    with pytest.raises(ValueError):
        LoopConfig(steps_per_call=-1)


def test_loop_runs_on_the_card_only_when_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(GCFG, DCFG, TrainConfig(), ProperSchedule(8, B, 3, 2),
                   synthetic_dataset(8, 32, 3, NUM_CLASSES),
                   LoopConfig(main_path=str(tmp_path)))


def test_snapshot_manifest_lists_the_port_sources(tmp_path):
    trial = _loop(tmp_path, total_iterations=1, snapshot_sources=True)
    with open(os.path.join(trial, "src_snapshot", "MANIFEST.json")) as f:
        manifest = json.load(f)
    for rel in ("train/loop.py", "ops/kernels/csrc/epilogue.cu",
                "cli/conditional_proper_cifar_train.py"):
        with open(os.path.join(REPO, "pgx_torch", rel), "rb") as f:
            assert manifest[rel] == hashlib.sha256(f.read()).hexdigest()
        assert os.path.exists(os.path.join(trial, "src_snapshot",
                                           "pgx_torch", rel))
    assert not any("__pycache__" in k for k in manifest)


@pytest.mark.parametrize("extra,header", [
    ([], "iter,g,d,grad,alpha"),
    (["--ada-p", "0.5"], "iter,g,d,grad,alpha,ada_p,ada_r"),
    (["--ada-heads", "--ada", "--ada-warp", "gather"],
     "iter,g,d,grad,alpha,ada_p,ada_r")])
def test_cli_trains_a_short_trial(tmp_path, extra, header):
    trial = cli.main(CLI_ARGS + ["--output", str(tmp_path)] + extra)
    assert os.path.basename(trial).startswith("trial_cond_proper_cifar_")
    rows = _rows(trial)
    assert rows[0] == header
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4", "6", "8"]
    assert all(np.isfinite([float(v) for v in r.split(",")])
               .all() for r in rows[1:])
    with open(os.path.join(trial, "timing.json")) as f:
        assert [v["resolution"] for v in json.load(f).values()] == [
            8, 8, 16, 16]
    assert sorted(os.listdir(os.path.join(trial, "sample"))) == [
        "001.png", "003.png", "006.png"]
    names = os.listdir(os.path.join(trial, "checkpoint"))
    for it in ("001", "003", "006", "008"):
        for kind in ("g.model", "d.model", "state.pt"):
            assert f"{it}_{kind}" in names
    cfg = tckpt.load_config(trial)
    assert cfg["generator"]["conditioning"] == (
        "norm_concat" if "--ada-heads" in extra else "concat")
    assert (cfg["augment"] is None) == (not extra)


@pytest.mark.parametrize("flags,match", [
    (["--steps-per-call", "4"], "steps_per_call"),
    (["--checkpoint-backend", "orbax"], "checkpoint_backend"),
    (["--gp-mode", "jvp"], "gp_mode"),
    (["--multihost"], "multihost")])
def test_cli_refuses_unported_flags(tmp_path, flags, match):
    """What is not ported raises; ``--steps-per-call`` and ``--gp-mode jvp``
    are ported: the CLI trains with them and saves them in the trial's
    config.  ``--checkpoint-backend orbax`` is ported: the CLI reaches
    ``train_loop`` with ``checkpoint_backend='orbax'``.  ``--multihost`` is
    ported: without a coordinator address it raises before anything
    trains; with one process it trains as without the flag."""
    if match == "checkpoint_backend":
        seen = {}

        def spy(*args, **kwargs):
            seen["loop_cfg"] = args[5]
            return "spy"
        with mock.patch.object(cli_common, "train_loop", spy):
            assert cli.main(CLI_ARGS + ["--output", str(tmp_path)]
                            + flags) == "spy"
        assert seen["loop_cfg"].checkpoint_backend == "orbax"
        return
    if match in ("steps_per_call", "gp_mode"):
        trial = cli.main(CLI_ARGS + ["--output", str(tmp_path)] + flags)
        rows = _rows(trial)
        assert [r.split(",")[0] for r in rows[1:]] == ["2", "4", "6", "8"]
        assert all(np.isfinite([float(v) for v in r.split(",")]).all()
                   for r in rows[1:])
        if match == "gp_mode":
            assert tckpt.load_config(trial)["train"]["gp_mode"] == "jvp"
        return
    with pytest.raises(ValueError, match="coordinator address"):
        cli.main(CLI_ARGS + ["--output", str(tmp_path)] + flags)
    trial = cli.main(CLI_ARGS + ["--output", str(tmp_path)] + flags
                     + ["--num-processes", "1"])
    rows = _rows(trial)
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4", "6", "8"]


def test_zoo_ada_generator_matches_pgx():
    for kw in (dict(), dict(z_dim=8, channel=16, max_step=3, num_classes=4,
                            tanh=True, dtype="bfloat16")):
        assert dataclasses.asdict(
            tzoo.conditional_correct_generator_ada(**kw)) == \
            dataclasses.asdict(jzoo.conditional_correct_generator_ada(**kw))


def test_cli_sigterm_leaves_an_emergency_checkpoint(tmp_path):
    """The CLI in its own process, sent SIGTERM once its first checkpoint
    is on disk, exits 143 with a full-state checkpoint at the iteration it
    stopped; ``--resume`` finishes the run from there."""
    args = (CLI_ARGS + ["--output", str(tmp_path), "--images-per-mini-step",
                        "60", "--checkpoint-every", "1000",
                        "--sample-every", "1000", "--log-every", "1000"])
    proc = subprocess.Popen([sys.executable, "-m",
                             "pgx_torch.cli.conditional_proper_cifar_train",
                             *args], cwd=REPO,
                            env={**os.environ, "OMP_NUM_THREADS": "1"},
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        first = None
        while time.monotonic() < deadline and proc.poll() is None:
            first = glob.glob(str(tmp_path / "trial_*" / "checkpoint" /
                                  "001_state.pt"))
            if first:
                break
            time.sleep(0.05)
        assert first, "no first checkpoint"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 143, out
    (trial,) = glob.glob(str(tmp_path / "trial_*"))
    states = sorted(glob.glob(os.path.join(trial, "checkpoint",
                                           "*_state.pt")))
    stopped = tckpt.checkpoint_iteration(states[-1])
    assert 1 <= stopped < 60
    assert f"emergency checkpoint saved at iteration {stopped}" in out
    assert _full_state(trial, stopped)["iteration"] == stopped
    seen = []
    from pgx_torch.cli import common
    from pgx_torch.train import loop as loop_mod
    orig = loop_mod.train_loop

    def spy(*a, **kw):
        kw["hooks"] = {"on_iteration": lambda i, st, s, m: seen.append(i)}
        return orig(*a, **kw)
    # the trainers reach train_loop through cli/common.run_trainer
    common.train_loop = spy
    try:
        # the rest of the run: a shorter schedule than the process had
        # would warn on drift, so the same flags are passed
        cli.main(args + ["--resume", trial])
    finally:
        common.train_loop = orig
    assert seen[0] == stopped and seen[-1] == 59
    assert os.path.exists(os.path.join(trial, "checkpoint",
                                       tckpt.state_name(60)))
