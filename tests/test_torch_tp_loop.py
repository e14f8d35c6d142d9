"""``train_loop`` and the trainer CLI with ``model_parallel=2`` on two gloo
ranks of the CPU (tests/torch_ddp_worker.py, cases ``tp_loop`` and
``cli``): the (1, 2) grid, the state sharded at rest, every host read
gathered.

* Rank 0 alone writes; the other rank's directory stays empty.
* **Layout-free checkpoints**: the model-2 trial's files (the npz pair and
  ``{iter}_state.pt`` at iterations 2 and 4) hold the same keys, shapes and
  values as those of the same run at model 1 over the same two ranks (pure
  data parallelism: the same rows, draws and sums), bit for bit; so do the
  two trials after each is resumed at model 2 (a model-1 checkpoint resumed
  at model 2) to iteration 6.  The same pair again in windows of 2
  iterations (``steps_per_call=2``: ``make_train_multi_step`` over the
  grid) writes the same files as each other.
* A copy of the model-2 trial at iteration 4 resumes at model 1 in this
  process (world 1) to iteration 6.
* The step-indexed store (``checkpoint_backend='orbax'``) stopped at 2 and
  resumed to 4 at model 2: its steps hold whole tensors.
* At the end of every run the blocks are equal within each data group and
  the gathered state on every rank (``check_replica_consistency(mesh=)``).
* The flagship family's trainer with ``--multihost --model-parallel 2``
  trains on the two ranks; in one process ``--model-parallel-mode
  spatial`` raises pgx's ``ValueError`` for too few devices (two ranks
  train in tests/test_torch_spatial_cli.py), and ``model_parallel=2``
  without the mesh pgx's ``ValueError``, before anything trains.  Launched
  with each rank on a host of its own (case ``cli_hosts``), it raises pgx's
  "the model axis must not span hosts" on every rank.
"""

import os

import numpy as np
import pytest
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.cli import conditional_proper_cifar_train as cli
from pgx_torch.data.datasets import synthetic_dataset
from pgx_torch.models import zoo
from pgx_torch.train import LoopConfig, ProperSchedule, TrainConfig
from pgx_torch.train.loop import train_loop
from tests.test_torch_parallel import run_ranks

CLI_ARGV = ["--device", "cpu", "--synthetic", "--channels", "8", "--z-dim",
            "8", "--num-classes", "3", "--max-step", "3", "--init-step", "2",
            "--images-per-mini-step", "8", "--batch-size", "4",
            "--sample-every", "2", "--checkpoint-every", "2",
            "--log-every", "2"]


@pytest.fixture(scope="module")
def tp_loop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_loop")
    inp = {"root": str(tmp / "rank0"), "root1": str(tmp / "rank1"),
           "copy": str(tmp / "copy")}
    os.makedirs(inp["root"])
    os.makedirs(inp["root1"])
    return inp, run_ranks("tp_loop", inp)


def _checkpoint_files(trial, it):
    d = os.path.join(trial, "checkpoint")
    return {kind: os.path.join(d, f"{it:03d}_{kind}")
            for kind in ("g.model", "d.model", "state.pt")}


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    else:
        out[prefix.rstrip(".")] = tree
    return out


def _assert_same_files(a, b, it):
    fa, fb = _checkpoint_files(a, it), _checkpoint_files(b, it)
    for kind in ("g.model", "d.model"):
        ta, tb = (_flat(ckpt.load_params(f[kind])) for f in (fa, fb))
        assert ta.keys() == tb.keys()
        for k in ta:
            assert ta[k].shape == tb[k].shape, (it, kind, k)
            np.testing.assert_array_equal(ta[k], tb[k],
                                          err_msg=f"{it} {kind} {k}")
    sa, sb = (_flat(torch.load(f["state.pt"], weights_only=True))
              for f in (fa, fb))
    assert sa.keys() == sb.keys()
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert sa[k].shape == sb[k].shape, (it, k)
            assert torch.equal(sa[k], sb[k]), (it, k)
        else:
            assert sa[k] == sb[k], (it, k)


def test_rank_0_alone_writes(tp_loop):
    inp, (r0, r1) = tp_loop
    assert r1["files"] == []
    for name in ("tp", "dp", "tp_window", "dp_window", "store"):
        trial = os.path.relpath(r0["trials"][name], inp["root"])
        assert any(f.startswith(trial) and f.endswith(".png")
                   for f in r0["files"]), name
    # every run's end checked on both ranks, the model-2 runs sharded
    runs = [(n, it) for n, it, _ in r0["checked"]]
    assert runs == [(n, it) for n, it, _ in r1["checked"]] == [
        ("tp", 4), ("dp", 4), ("tp", 6), ("dp", 6), ("store", 2),
        ("store", 4)]
    for (n, it, names) in r0["checked"]:
        assert bool(names) == (n != "dp" or it == 6), (n, it)


def test_checkpoints_are_layout_free(tp_loop):
    _, (r0, _) = tp_loop
    tp_trial, dp_trial = r0["trials"]["tp"], r0["trials"]["dp"]
    for it in (2, 4, 6):
        _assert_same_files(tp_trial, dp_trial, it)
    for it in (2, 4):
        _assert_same_files(r0["trials"]["tp_window"],
                           r0["trials"]["dp_window"], it)


def test_model_2_checkpoint_resumes_at_model_1_here(tp_loop):
    inp, _ = tp_loop
    # the worker's pair (tests/torch_ddp_worker.py:_tiny_pair; that module
    # is not imported here: it refuses JAX imports in its process)
    gcfg = zoo.conditional_correct_generator(
        z_dim=8, num_classes=3, channel=8, max_step=3, dtype="float32")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=8, num_classes=3, max_step=3, dtype="float32")
    ds = synthetic_dataset(n=64, size=32, channels=3, num_classes=3, seed=0)
    sched = ProperSchedule(images_seen_per_mini_step=16, batch_size=8,
                           max_step=3, init_step=2)
    first = []
    trial = train_loop(
        gcfg, dcfg, TrainConfig(), sched, ds,
        LoopConfig(trial_name="tp", main_path=inp["copy"], batch_size=8,
                   sample_every=2, checkpoint_every=2, log_every=2,
                   total_iterations=6, verbose=False,
                   snapshot_sources=False),
        resume_dir=inp["copy"],
        hooks={"on_iteration": lambda i, st, s, m: first.append(i)},
        device="cpu")
    assert first == [4, 5]
    assert ckpt.checkpoint_iteration(
        ckpt.latest_checkpoint(trial, "g")) == 6
    saved = torch.load(_checkpoint_files(trial, 6)["state.pt"],
                       weights_only=True)
    assert saved["iteration"] == 6


def test_store_at_model_2_holds_whole_tensors(tp_loop):
    _, (r0, _) = tp_loop
    store_trial, dp_trial = r0["trials"]["store"], r0["trials"]["dp"]
    assert sorted(os.listdir(os.path.join(store_trial, "step_state"))) == [
        "1", "2", "3", "4"]
    assert not any(n.endswith("_state.pt") for n in os.listdir(
        os.path.join(store_trial, "checkpoint")))
    got = _flat(torch.load(os.path.join(store_trial, "step_state", "4",
                                        "state.pt"), weights_only=True))
    want = _flat(torch.load(_checkpoint_files(dp_trial, 4)["state.pt"],
                            weights_only=True))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].shape == v.shape, k


def test_trainer_cli_with_model_parallel_2(tmp_path):
    root, root1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    os.makedirs(root)
    os.makedirs(root1)
    outs = run_ranks("cli", {"argv": CLI_ARGV + ["--model-parallel", "2"],
                             "root": root, "root1": root1})
    assert outs[1]["files"] == []
    states = [f for f in outs[0]["files"] if f.endswith("_state.pt")]
    assert states
    saved = torch.load(os.path.join(root, states[-1]), weights_only=True)
    # whole tensors: the generator's 3x3 convs at their full 8 channels
    assert saved["g"]["blocks.8.conv1.w"].shape == (3, 3, 8, 8)
    assert saved["opt_g"]["mu"]["blocks.8.conv1.w"].shape == (3, 3, 8, 8)
    with pytest.raises(ValueError, match="model_parallel=2 does not "
                                         "divide the 1 available"):
        cli.main(CLI_ARGV + ["--model-parallel", "2",
                             "--model-parallel-mode", "spatial",
                             "--output", str(tmp_path / "spatial")])
    assert not os.path.exists(tmp_path / "spatial")
    with pytest.raises(ValueError, match="model_parallel requires "
                                         "use_mesh=True"):
        LoopConfig(model_parallel=2, use_mesh=False)
    with pytest.raises(ValueError, match="model_parallel requires "
                                         "use_mesh=True"):
        cli.main(CLI_ARGV + ["--model-parallel", "2", "--no-mesh",
                             "--output", str(tmp_path / "no_mesh")])


def test_trainer_cli_refuses_a_model_axis_across_hosts(tmp_path, monkeypatch):
    import jax

    from pgx.parallel import tp as jtp
    root, root1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    os.makedirs(root)
    os.makedirs(root1)
    outs = run_ranks("cli_hosts", {"argv": CLI_ARGV + ["--model-parallel",
                                                       "2"],
                                   "root": root, "root1": root1})
    monkeypatch.setattr(jtp.jax, "process_count", lambda: 2)
    monkeypatch.setattr(jtp.jax, "local_device_count", lambda: 1)
    with pytest.raises(ValueError) as spans:
        jtp.make_mesh_2d(1, 2, devices=jax.devices()[:2])
    for o in outs:
        assert o == {"error": str(spans.value), "world": 2}
