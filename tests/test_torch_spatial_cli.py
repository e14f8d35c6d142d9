"""The flagship family's trainer with ``--multihost --model-parallel 2
--model-parallel-mode spatial`` on two gloo ranks of the CPU
(tests/torch_ddp_worker.py, case ``cli``), the tiny pair of
tests/test_torch_tp_loop.py at 8px: the (1, 2) grid, every image split
over H, the state whole on every rank.

* Rank 0 alone writes the trial; the other rank's directory stays empty.
* Stopped at 4 iterations, its checkpoint holds whole tensors and agrees
  with the same run at world 1 in this process: the data position's
  stream is world 1's (seed + 0), the draws the global batch's, so only
  the order of the sums differs (f32: parameters and Adam's moments
  within 1e-5 of each tensor's largest entry, the CSV's losses at 1e-4).
* The trial resumes at model 1 in this process (world 1) to the end of
  the schedule.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import torch

from pgx_torch.cli import common
from pgx_torch.cli import conditional_proper_cifar_train as cli
from tests.test_torch_parallel import run_ranks
from tests.test_torch_tp_loop import CLI_ARGV

CUT = 4


def cut_loop_config(total):
    """The worker's ``cut_loop_config`` here (importing the worker would
    install its import block in this process): the trainer stopped at
    ``total`` iterations."""
    original = common.loop_config_from_args
    return mock.patch.object(
        common, "loop_config_from_args",
        lambda args, **kw: dataclasses.replace(original(args, **kw),
                                               total_iterations=total))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _rows(trial):
    name = [f for f in os.listdir(trial) if f.startswith("train_log_")][0]
    with open(os.path.join(trial, name)) as f:
        return [line.split(",") for line in f.read().split()[1:]]


def test_trainer_cli_spatial_at_model_2_then_model_1(tmp_path):
    root, root1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    os.makedirs(root)
    os.makedirs(root1)
    outs = run_ranks("cli", {
        "argv": CLI_ARGV + ["--model-parallel", "2",
                            "--model-parallel-mode", "spatial"],
        "root": root, "root1": root1, "total": CUT})
    assert outs[1]["files"] == []
    assert (outs[0]["world"], outs[0]["backend"]) == (2, "gloo")
    trial = outs[0]["trial"]
    with cut_loop_config(CUT):
        world1 = cli.main(CLI_ARGV + ["--output", str(tmp_path / "w1")])
    name = f"checkpoint/{CUT:03d}_state.pt"
    got = _flat(torch.load(os.path.join(trial, name), weights_only=True))
    want = _flat(torch.load(os.path.join(world1, name), weights_only=True))
    assert got.keys() == want.keys()
    # whole tensors: the generator's 3x3 convs at their full 8 channels
    assert got["g.blocks.8.conv1.w"].shape == (3, 3, 8, 8)
    compared = 0
    for k, v in want.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            scale = max(float(v.abs().max()), 1e-30)
            err = float((got[k] - v).abs().max())
            assert err <= 1e-5 * scale, (k, err, scale)
            compared += 1
    assert compared > 100
    rows, rows1 = _rows(trial), _rows(world1)
    assert [r[0] for r in rows] == [r[0] for r in rows1] == ["2", "4"]
    np.testing.assert_allclose(np.array(rows, float), np.array(rows1, float),
                               rtol=1e-4, atol=1e-4)
    # resumed at model 1, one process, to the schedule's end
    resumed = cli.main(CLI_ARGV + ["--output", str(tmp_path / "resume"),
                                   "--resume", trial])
    assert resumed == trial
    its = [r[0] for r in _rows(trial)]
    assert its[:2] == ["2", "4"] and len(its) > 2
    assert os.path.exists(os.path.join(
        trial, "checkpoint", f"{int(its[-1]):03d}_state.pt"))
