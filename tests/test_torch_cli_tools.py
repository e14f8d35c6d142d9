"""pgx_torch's tool entry points against pgx's on the CPU: generate,
grow_checkpoint, profile_step, augmentation_demo and create_gif, and the
refusal of the default card where there is none.

The trials are written by pgx (its initialisers, ``save_config`` and
``save_params``) at a tiny size, f32: a conditional 'proper' pair, a
conditional legacy pair with label-plane D, and the unconditional MNIST
pair.  Tolerances: generate 1e-5 of pgx's images (f32, CPU); the grown
config JSON, every copied leaf, the key sets and shapes exact; the p = 0 row
of the augmentation grid and the GIF's bytes exact.
"""

import dataclasses
import importlib
import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from pgx import checkpoint as jckpt
from pgx.models import init_discriminator as jinit_d
from pgx.models import init_generator as jinit_g
from pgx.models import zoo as jzoo
from pgx.train import LegacySchedule as JLegacySchedule
from pgx.train import ProperSchedule as JProperSchedule
from pgx.train import TrainConfig as JTrainConfig
from pgx.train.schedule import schedule_to_dict as jsched_to_dict
from pgx.utils.png import save_image_grid as jsave_grid
from pgx_torch import checkpoint as tckpt
from pgx_torch.models import zoo as tzoo

FAMILIES = {
    "cond_proper": lambda: (
        jzoo.conditional_correct_generator(z_dim=8, num_classes=3, channel=8,
                                           max_step=3),
        jzoo.conditional_correct_discriminator_wgangp(
            feat_dim=8, num_classes=3, max_step=3)),
    "cond_legacy": lambda: (
        jzoo.conditional_generator(z_dim=8, num_classes=3, channel=8,
                                   max_step=2),
        jzoo.conditional_discriminator_wgangp(feat_dim=8, num_classes=3,
                                              max_step=2)),
    "mnist": lambda: (jzoo.mnist_generator(z_dim=8, channel=8),
                      jzoo.mnist_discriminator(feat_dim=8)),
}
GROW = {   # (target channels, target max step, check step): a stage more
    "cond_proper": ("8,8,8,8,4,2,2", 7, 3),
    "cond_legacy": ("8,8,8,8,4,2,2,2", 5, 2),
    "mnist": ("8,8,8,8,8", 4, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pgx_trial(root, family, iters=None):
    """A trial directory written by pgx: configs, schedule, and G/D params
    at ``iters`` (seeded per iteration) and a 5 x 10 sample grid at each.
    The proper family's ``ProperSchedule(8, 4, 3)`` (4px 0-1, 8px 2-5, 16px
    6-9) and the legacy families' ``LegacySchedule(4 * max_step,
    max_step)`` (stages of 5) both sample the last checkpoint at step 3 or 2
    fading at alpha 0.5."""
    gcfg, dcfg = FAMILIES[family]()
    trial = os.path.join(str(root), f"trial_{family}")
    os.makedirs(os.path.join(trial, "checkpoint"))
    os.makedirs(os.path.join(trial, "sample"))
    if family == "cond_proper":
        sched, iters = JProperSchedule(8, 4, gcfg.max_step, 1), iters or (4, 8)
    else:
        sched = JLegacySchedule(4 * gcfg.max_step, gcfg.max_step, 1)
        iters = iters or (3, 7)
    jckpt.save_config(trial, gcfg, dcfg, JTrainConfig(),
                      extra={"schedule": jsched_to_dict(sched)},
                      postfix=family)
    rng = np.random.RandomState(0)
    for it in iters:
        kg, kd = jax.random.split(jax.random.PRNGKey(it))
        jckpt.save_params(os.path.join(trial, "checkpoint",
                                       jckpt.checkpoint_name(it, "g")),
                          jinit_g(kg, gcfg))
        jckpt.save_params(os.path.join(trial, "checkpoint",
                                       jckpt.checkpoint_name(it, "d")),
                          jinit_d(kd, dcfg))
        res = gcfg.resolution(sched.state_at(it - 1).step)
        jsave_grid(os.path.join(trial, "sample", f"{it:03d}.png"),
                   rng.uniform(-1, 1, (50, res, res, gcfg.img_channels)),
                   nrow=10)
    return trial


def _png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_matches_pgx(tmp_path, family):
    from pgx.cli import generate as jgen
    from pgx_torch.cli import generate as tgen
    trial = pgx_trial(tmp_path, family)
    outs = {}
    for name, main, extra in (("pgx", jgen.main, []),
                              ("port", tgen.main, ["--device", "cpu"])):
        png = str(tmp_path / f"{name}.png")
        npz = str(tmp_path / f"{name}.npz")
        assert main(["--trial", trial, "--per-class", "4", "--num", "7",
                     "--batch-size", "5", "--seed", "3", "--out", png,
                     "--npz", npz] + extra) == png
        with np.load(npz) as data:
            outs[name] = {k: data[k] for k in data.files}
        outs[name]["grid"] = _png(png)
    want, got = outs["pgx"], outs["port"]
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["z"], want["z"])
    if "labels" in want:
        np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["images"].shape == want["images"].shape
    assert got["images"].dtype == np.float32
    np.testing.assert_allclose(got["images"], want["images"], rtol=0,
                               atol=1e-5)
    assert got["grid"].shape == want["grid"].shape


def test_generate_pins_a_checkpoint_and_refuses_a_missing_one(tmp_path):
    from pgx_torch.cli import generate as tgen
    trial = pgx_trial(tmp_path, "mnist")
    out = tgen.main(["--trial", trial, "--checkpoint", "3", "--num", "3",
                     "--device", "cpu"])
    assert out == os.path.join(trial, "generated_3.png")
    # step 1 (8px) at iteration 3: one row of ten cells, three filled
    assert _png(out).shape == (8 + 4, 10 * (8 + 2) + 2)
    with pytest.raises(SystemExit, match="no checkpoint 5"):
        tgen.main(["--trial", trial, "--checkpoint", "5", "--device", "cpu"])


def _leaves(tree, prefix=""):
    return jckpt._flatten(tree, prefix)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grow_checkpoint_matches_pgx(tmp_path, family):
    from pgx.cli import grow_checkpoint as jgrow
    from pgx_torch.cli import grow_checkpoint as tgrow
    trial = pgx_trial(tmp_path, family)
    channels, max_step, check = GROW[family]
    argv = ["--trial", trial, "--target-channels", channels,
            "--target-max-step", str(max_step), "--check-step", str(check)]
    jout = jgrow.main(argv + ["--out", str(tmp_path / "jax_grown")])
    tout = tgrow.main(argv + ["--out", str(tmp_path / "port_grown"),
                              "--device", "cpu"])
    assert tckpt.load_config(tout) == jckpt.load_config(jout)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    last = os.path.basename(jckpt.latest_checkpoint(trial, "g"))[:3]
    assert sorted(os.listdir(os.path.join(tout, "checkpoint"))) == [
        f"{last}_d.model", f"{last}_g.model"]
    for kind in ("g", "d"):
        small = _leaves(jckpt.load_params(jckpt.latest_checkpoint(trial,
                                                                  kind)))
        want = _leaves(jckpt.load_params(jckpt.latest_checkpoint(jout, kind)))
        got = _leaves(tckpt.load_params(tckpt.latest_checkpoint(tout, kind)))
        assert got.keys() == want.keys() and set(small) < set(got)
        for k in got:
            assert got[k].shape == want[k].shape, (kind, k)
            assert got[k].dtype == want[k].dtype, (kind, k)
        for k in small:          # copied: the small trial's, bit for bit
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], small[k], err_msg=k)
    # the grown trial samples its new top stage in both packages
    cfg = tckpt.load_config(tout)
    assert cfg["schedule"]["max_step"] == max_step


def test_grow_checkpoint_new_leaves_are_seeded(tmp_path):
    """The new leaves come from the port's initialisers at ``--seed``: the
    same seed gives the same file, another seed other new leaves and the
    same copied ones."""
    from pgx_torch.cli import grow_checkpoint as tgrow
    trial = pgx_trial(tmp_path, "mnist")
    grown = {}
    for out, seed in (("a", 0), ("b", 0), ("c", 1)):
        d = tgrow.main(["--trial", trial, "--target-channels", "8,8,8,8,8",
                        "--target-max-step", "4", "--seed", str(seed),
                        "--out", str(tmp_path / out), "--device", "cpu"])
        grown[out] = _leaves(tckpt.load_params(
            tckpt.latest_checkpoint(d, "g")))
    small = _leaves(jckpt.load_params(jckpt.latest_checkpoint(trial, "g")))
    new = sorted(set(grown["a"]) - set(small))
    assert new
    for k in grown["a"]:
        np.testing.assert_array_equal(grown["a"][k], grown["b"][k])
    assert any(not np.array_equal(grown["a"][k], grown["c"][k])
               for k in new if grown["a"][k].any())
    for k in small:
        np.testing.assert_array_equal(grown["c"][k], small[k])


def test_grow_checkpoint_equivalence_fails_on_a_broken_copy(tmp_path):
    """The check runs: a grower that copies nothing fails it."""
    from pgx_torch.cli import grow_checkpoint as tgrow
    trial = pgx_trial(tmp_path, "mnist")
    with mock.patch.object(tgrow.ckpt, "grow_params",
                           lambda small, big: big), \
            pytest.raises(AssertionError):
        tgrow.main(["--trial", trial, "--target-channels", "8,8,8,8,8",
                    "--target-max-step", "4", "--device", "cpu"])


def test_profile_step_writes_a_trace(tmp_path):
    """The flagship factory patched to a tiny pair: one warm-up step, the
    traced steps, the timed steps (each step's time reported); the trace
    is a Chrome trace that names the step's ops."""
    from pgx_torch.cli import profile_step as tprof

    def tiny(step, dtype):
        return (tzoo.conditional_correct_generator(
                    z_dim=8, num_classes=3, channel=8, max_step=3,
                    dtype=dtype),
                tzoo.conditional_correct_discriminator_wgangp(
                    feat_dim=8, num_classes=3, max_step=3, dtype=dtype))

    out = str(tmp_path / "trace")
    with mock.patch.object(tprof, "flagship_configs", tiny):
        res = tprof.main(["--out", out, "--steps", "2", "--batch-size", "4",
                          "--step", "3", "--dtype", "float32",
                          "--gp-mode", "jvp", "--device", "cpu"])
    assert res["iterations"] == 5 and res["img_per_s"] > 0
    assert len(res["step_ms"]) == 2 and min(res["step_ms"]) > 0
    assert sum(res["step_ms"]) <= 2 * res["ms_per_step"]
    (name,) = os.listdir(out)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(out, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names


def test_profile_step_flagship_configs_are_pgx_s():
    """The port's flagship pair is __graft_entry__'s; past step 6 the grown
    plan."""
    from __graft_entry__ import _flagship_configs
    from pgx_torch.cli.profile_step import flagship_configs
    for dtype in ("bfloat16", "float32"):
        for ours, theirs in zip(flagship_configs(6, dtype),
                                _flagship_configs(dtype)):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for ours, theirs in zip(flagship_configs(8, "bfloat16"),
                            jzoo.conditional_correct_grown(
                                8, dtype="bfloat16")):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("size", [16, 64])
def test_augmentation_demo_matches_pgx(tmp_path, size):
    """Same grid shape; the p = 0 row (no transform applies, whatever the
    draws) equal to pgx's byte for byte; the p > 0 rows augmented."""
    from pgx.cli import augmentation_demo as jdemo
    from pgx_torch.cli import augmentation_demo as tdemo
    argv = ["--synthetic", "--rows", "2", "--cols", "3", "--size",
            str(size), "--seed", "1"]
    jdemo.main(argv + ["--out", str(tmp_path / "jax.png")])
    tdemo.main(argv + ["--out", str(tmp_path / "port.png"), "--device",
                       "cpu"])
    want, got = _png(tmp_path / "jax.png"), _png(tmp_path / "port.png")
    assert got.shape == want.shape == (2 + 2 * (size + 2),
                                       2 + 3 * (size + 2), 3)
    row0 = slice(0, size + 4)
    np.testing.assert_array_equal(got[row0], want[row0])
    assert not np.array_equal(got[size + 4:], got[row0][:size])


def test_create_gif_matches_pgx(tmp_path):
    from pgx.cli import create_gif as jgif
    from pgx_torch.cli import create_gif as tgif
    trial = pgx_trial(tmp_path, "cond_proper", iters=(1, 3, 8))
    argv = ["--trial", trial, "--cell-size", "12", "--frame-ms", "50"]
    jgif.main(argv + ["--out", str(tmp_path / "jax.gif")])
    tgif.main(argv + ["--out", str(tmp_path / "port.gif")])
    with open(tmp_path / "jax.gif", "rb") as f, \
            open(tmp_path / "port.gif", "rb") as g:
        assert f.read() == g.read()
    from PIL import Image
    with Image.open(tmp_path / "port.gif") as im:
        assert im.n_frames == 3


TRAINERS = ("train", "mnist_train", "cifar_train", "proper_cifar_train",
            "conditional_cifar10_wgan_train", "conditional_mnist_wgan_train",
            "conditional_proper_wikiart")


@pytest.mark.parametrize("name,argv", [
    ("generate", ["--trial", "T"]),
    ("grow_checkpoint", ["--trial", "T", "--target-channels", "8",
                         "--target-max-step", "2"]),
    ("profile_step", []),
    ("augmentation_demo", ["--synthetic"]),
    *[(n, ["--synthetic", "--output", "OUT"]) for n in TRAINERS]])
def test_cuda_is_the_default_device(tmp_path, name, argv):
    """Without ``--device cpu`` every device-using entry point asks for the
    card and raises where there is none; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"pgx_torch.cli.{name}").main
    argv = [str(tmp_path) if a == "OUT" else a for a in argv]
    with mock.patch("pgx_torch.train.loop.make_trial_dir",
                    side_effect=AssertionError("reached the loop")), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
