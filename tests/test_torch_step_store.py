"""The step-indexed store of the full train state
(``pgx_torch.checkpoint.step_store``, the port's counterpart of pgx's orbax
backend) and ``LoopConfig(checkpoint_backend='orbax')``, on the CPU.

* a round trip, synchronous and in the background, restores every tensor
  bit for bit, the state as it was when ``save`` returned (the state is
  changed right after it);
* a step still being written (``{iter}.tmp``) is not listed;
* an error in the writer is raised again by the next ``save``, ``wait`` or
  ``close``;
* ``_load_newest_state`` restores the newer of ``*_state.pt`` and the store
  (the store on a tie);
* pgx's loop with its orbax backend and the port's loop with the store, each
  stopped and resumed from its own full state, end with the same CSV and the
  same final parameters.  Both start from one pgx-written npz pair (fresh
  Adam), read the same batches and draw z and eps from pgx's key chain (the
  port replays it with ``draws=``, one chain over both legs: pgx restores
  its key from its state).  Compute is float64 on float32 master weights;
  tolerances as in tests/test_torch_loop_parity.py: metrics in the CSV 1e-4
  of max(|value|, 1) plus 1e-5 for the 5-decimal rounding, the final npz
  1e-5 absolute.
"""

import glob
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
from pgx_torch.checkpoint import step_store
from pgx_torch.checkpoint.step_store import StepStateStore, has_step_state
from pgx_torch.data import synthetic_dataset as tsynthetic
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import ProperSchedule as TProperSchedule
from pgx_torch.train import wgan as twgan
from pgx_torch.train.loop import LoopConfig as TLoopConfig
from pgx_torch.train.loop import _load_newest_state
from pgx_torch.train.loop import train_loop as ttrain_loop

B, NUM_CLASSES, SEED = 4, 3, 0
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=3)
DKW = {k: v for k, v in KW.items() if k != "z_dim"}
TG = tzoo.conditional_correct_generator(channel=8, **KW)
TD = tzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)
RTOL, CSV_ATOL, NPZ_ATOL = 1e-4, 1e-5, 1e-5


def _state(seed=0):
    state = twgan.init_train_state(TG, TD, twgan.TrainConfig(), seed=seed,
                                   device="cpu")
    state["rng"] = torch.Generator().manual_seed(seed)
    torch.rand(3, generator=state["rng"])
    with torch.no_grad():
        for k in ("opt_g", "opt_d"):
            for m in ("mu", "nu"):
                for t in state[k][m].values():
                    t.normal_(generator=state["rng"])
    state["iteration"] = 7 + seed
    return state


def _tensors(state):
    out = {f"{k}.{n}": t.detach().clone()
           for k in ("g", "d", "g_ema")
           for n, t in state[k].state_dict().items()}
    out.update({f"{k}.{m}.{n}": t.clone() for k in ("opt_g", "opt_d")
                for m in ("mu", "nu") for n, t in state[k][m].items()})
    out.update({f"ada.{n}": t.clone() for n, t in state["ada"].items()})
    out["rng"] = state["rng"].get_state()
    return out


@pytest.mark.parametrize("async_save", [True, False])
def test_round_trip_is_bitwise(tmp_path, async_save):
    state = _state()
    want = _tensors(state)
    store = StepStateStore(str(tmp_path), async_save=async_save)
    store.save(7, state)
    with torch.no_grad():      # training goes on at once
        for p in state["g"].parameters():
            p.add_(1.0)
        state["opt_d"]["mu"][next(iter(state["opt_d"]["mu"]))].zero_()
    store.close()
    assert store.latest_iteration() == 7 and has_step_state(str(tmp_path))
    assert os.listdir(tmp_path / "step_state") == ["7"]
    other = _state(seed=1)
    g_params = list(other["g"].parameters())
    assert StepStateStore(str(tmp_path)).restore(7, other) is other
    assert all(a is b for a, b in zip(g_params, other["g"].parameters()))
    got = _tensors(other)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert other["iteration"] == 7


def test_a_step_being_written_is_not_listed(tmp_path):
    root = tmp_path / "step_state"
    os.makedirs(root / "9.tmp")
    torch.save({}, root / "9.tmp" / "state.pt")
    os.makedirs(root / "5")               # a commit never renamed in
    assert not has_step_state(str(tmp_path))
    store = StepStateStore(str(tmp_path), async_save=False)
    assert store.latest_iteration() is None
    store.save(3, _state())
    assert store.latest_iteration() == 3
    store.save(3, _state(seed=2))         # the same step again
    assert sorted(os.listdir(root)) == ["3", "5", "9.tmp"]
    other = _state()
    store.restore(3, other)
    assert other["iteration"] == 9


@pytest.mark.parametrize("then", ["save", "wait", "close"])
def test_a_writer_error_is_raised_again(tmp_path, monkeypatch, then):
    def fail(payload, path):
        raise OSError("disk full")
    monkeypatch.setattr(step_store.torch, "save", fail)
    store = StepStateStore(str(tmp_path))
    store.save(4, _state())               # returns: the write is behind it
    with pytest.raises(OSError, match="disk full"):
        if then == "save":
            store.save(5, _state())
        else:
            getattr(store, then)()
    monkeypatch.undo()
    store.save(6, _state())               # raised once, not again
    store.close()
    assert store.latest_iteration() == 6


@pytest.mark.parametrize("file_it,store_it,want", [
    (4, 6, "store"), (6, 4, "file"), (5, 5, "store"), (None, 3, "store")])
def test_resume_takes_the_newer_full_state(tmp_path, file_it, store_it,
                                           want):
    trial = str(tmp_path)
    os.makedirs(os.path.join(trial, "checkpoint"))
    saved = {}
    if file_it is not None:
        state = _state(seed=2)
        state["iteration"] = file_it
        tckpt.save_checkpoint(trial, file_it, state)
        saved["file"] = _tensors(state)
    state = _state(seed=3)
    state["iteration"] = store_it
    StepStateStore(trial, async_save=False).save(store_it, state)
    saved["store"] = _tensors(state)
    other = _state(seed=4)
    _, start = _load_newest_state(trial, other)
    assert start == (store_it if want == "store" else file_it)
    got = _tensors(other)
    assert all(torch.equal(got[k], v) for k, v in saved[want].items())


# ---------------------------------------------------------------------------
# The loop against pgx's loop with its orbax backend
# ---------------------------------------------------------------------------

JG = jzoo.conditional_correct_generator(channel=8, **dict(KW,
                                                           dtype="float64"))
JD = jzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **dict(DKW, dtype="float64"))
TG64 = tzoo.conditional_correct_generator(channel=8, **dict(KW,
                                                             dtype="float64"))
TD64 = tzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **dict(DKW, dtype="float64"))
# ProperSchedule(8, 4, 3, 2): 8px, iterations 0-1 fading, 2-3 stable
FIRST, STOP, TOTAL = 1, 3, 4
LOOP = dict(trial_name="orb", batch_size=B, sample_every=100,
            checkpoint_every=2, log_every=1, seed=SEED,
            snapshot_sources=False, verbose=False)


class PgxKeyChain:
    """pgx's draws iteration by iteration: ``PRNGKey(seed)`` split in three
    by ``init_train_state`` (the third part is ``state["rng"]``, fresh after
    a model-only resume), then ``split(rng, 6)`` per iteration."""

    def __init__(self, seed):
        _, _, self.rng = jax.random.split(jax.random.PRNGKey(seed), 3)

    def __call__(self, i, real):
        self.rng, kz, keps, _, _, _ = jax.random.split(self.rng, 6)
        bsz = real.shape[0]
        z = jax.random.normal(kz, (bsz, JG.z_dim), jnp.float32)
        eps = jax.random.uniform(keps, (bsz, 1, 1, 1), jnp.float32)
        return (torch.from_numpy(np.array(z)),
                torch.from_numpy(np.array(eps)), None)


def _pgx_loop(main_path, total, resume_dir=None, **kw):
    return jtrain_loop(
        JG, JD, jwgan.TrainConfig(), JProperSchedule(8, B, 3, 2),
        jsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
        JLoopConfig(main_path=main_path, total_iterations=total,
                    use_mesh=False, **dict(LOOP, **kw)),
        resume_dir=resume_dir)


def _port_loop(main_path, total, resume_dir, draws):
    return ttrain_loop(
        TG64, TD64, twgan.TrainConfig(), TProperSchedule(8, B, 3, 2),
        tsynthetic(16, 32, 3, NUM_CLASSES, seed=SEED),
        TLoopConfig(main_path=main_path, total_iterations=total,
                    checkpoint_backend="orbax", **LOOP),
        resume_dir=resume_dir, device="cpu", draws=draws)


def _csv(trial):
    (path,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [[float(v) for v in row.split(",")] for row in lines[1:]]


def test_stopped_and_resumed_loop_matches_pgx_with_orbax(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        first = _pgx_loop(str(tmp_path / "first"), FIRST,
                          keep_full_state=False)
    name = os.path.basename(first)
    pj, pt = str(tmp_path / "pgx" / name), str(tmp_path / "port" / name)
    shutil.copytree(first, pj)
    shutil.copytree(first, pt)
    chain = PgxKeyChain(SEED)
    for total in (STOP, TOTAL):       # stop at STOP, resume from the store
        _pgx_loop(str(tmp_path), total, resume_dir=pj,
                  checkpoint_backend="orbax")
        _port_loop(str(tmp_path), total, pt, chain)
    # the same steps committed, and no *_state.pt beside the npz pairs
    assert sorted(map(int, os.listdir(os.path.join(pt, "step_state")))) == \
        sorted(map(int, os.listdir(os.path.join(pj, "orbax_state")))) == \
        [2, 3, 4]
    assert not glob.glob(os.path.join(pt, "checkpoint", "*_state.pt"))
    jhead, jrows = _csv(pj)
    thead, trows = _csv(pt)
    assert thead == jhead
    assert [r[0] for r in trows] == [r[0] for r in jrows] == [1, 2, 3, 4]
    for got, want in zip(trows, jrows):
        assert got[4] == want[4]                           # alpha
        for g, w in zip(got[1:4], want[1:4]):
            assert abs(g - w) <= RTOL * max(abs(w), 1.0) + CSV_ATOL, (
                got, want)
    for kind in ("g", "d"):
        jpath, tpath = (jckpt.latest_checkpoint(pj, kind),
                        tckpt.latest_checkpoint(pt, kind))
        assert os.path.basename(tpath) == os.path.basename(jpath) == (
            f"{TOTAL:03d}_{kind}.model")
        got = tckpt._flatten(tckpt.load_params(tpath))
        want = tckpt._flatten(tckpt.load_params(jpath))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=NPZ_ATOL, err_msg=k)
