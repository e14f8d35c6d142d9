"""The seven family trainers of pgx_torch.cli against pgx's CLIs.

Each trainer is a ``main`` over ``train_loop``.  With ``train_loop``
replaced by a spy in both packages' CLI modules nothing trains, and what
each CLI hands the loop is compared at a tiny config: the generator,
discriminator, ``TrainConfig`` and ``LoopConfig`` field by field where both
packages define the field (dtypes by name), ``schedule_to_dict``, the augment
configs, and the first batch of the ``batch_fn`` stream, bit for bit, over
the same synthetic, digits, folder or WikiArt data.  Then each port trainer
runs for real on the CPU (channels 8): the trial-directory prefix, the CSV
header and iteration column, and the sample and checkpoint names.
"""

import dataclasses
import importlib
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from pgx.train.schedule import schedule_to_dict as jax_schedule_to_dict
from pgx_torch.train.schedule import schedule_to_dict

TINY = ["--batch-size", "4", "--log-every", "100", "--sample-every", "100",
        "--checkpoint-every", "100", "--no-mesh", "--channels", "8",
        "--z-dim", "8"]
LEGACY = ["--total-iter", "4", "--max-step", "2"]
PROPER = ["--images-per-mini-step", "8", "--max-step", "2"]

# (trainer, trial-name default, its flags for a tiny two-stage run)
TRAINERS = {
    "train": ("celeba", LEGACY),
    "mnist_train": ("mnist", LEGACY),
    "cifar_train": ("cifar", LEGACY),
    "proper_cifar_train": ("proper_cifar", PROPER),
    "conditional_cifar10_wgan_train": ("cond_cifar",
                                       LEGACY + ["--num-classes", "3"]),
    "conditional_mnist_wgan_train": ("cond_mnist",
                                     LEGACY + ["--num-classes", "3"]),
    "conditional_proper_wikiart": ("wikiart",
                                   PROPER + ["--num-classes", "3"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: more intra-op threads only contend with the other test
    processes of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(root, n, size=(40, 48), seed=0):
    """``n`` random RGB PNGs of ``size`` (w, h) in ``root``."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, size[::-1] + (3,))
                        .astype(np.uint8)).save(
            os.path.join(root, f"img{i:02d}.png"))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two class folders of eight images each."""
    root = str(tmp_path_factory.mktemp("folder"))
    for k, cls in enumerate(("a", "b")):
        _images(os.path.join(root, cls), 8, seed=k)
    return root


@pytest.fixture(scope="module")
def wikiart(tmp_path_factory):
    """Three categories of four images, one more too small for 8px, and
    the metadata CSV the port's ``prep.create_metadata`` writes."""
    from pgx_torch.data import prep
    root = str(tmp_path_factory.mktemp("wikiart"))
    for k, cat in enumerate(("baroque", "cubism", "pop")):
        _images(os.path.join(root, cat), 4, seed=10 + k)
    from PIL import Image
    Image.new("RGB", (6, 7)).save(os.path.join(root, "pop", "tiny.png"))
    csv_path = os.path.join(root, "data_info.csv")
    prep.create_metadata(root, csv_path)
    return root, csv_path


def _loop_owner(module):
    """Where ``module.main`` looks ``train_loop`` up: pgx's trainers import
    it themselves, the port's reach it through ``cli/common.run_trainer``."""
    if module.__name__.startswith("pgx_torch."):
        return importlib.import_module("pgx_torch.cli.common")
    return module


def _spy_run(module, argv):
    """``module.main(argv)`` with ``train_loop`` replaced: returns its
    positional and keyword arguments."""
    seen = {}

    def spy(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return "spy"

    with mock.patch.object(_loop_owner(module), "train_loop", spy):
        assert module.main(argv) == "spy"
    return seen["args"], seen["kwargs"]


def _normal(value):
    """Comparable across the packages: tuples as lists (dtypes are
    config strings, compared by name)."""
    if isinstance(value, (list, tuple)):
        return [_normal(v) for v in value]
    if isinstance(value, dict):
        return {k: _normal(v) for k, v in value.items()}
    return value


def _same_fields(ours, theirs, what):
    """Every field both dataclasses define holds the same value."""
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    common = a.keys() & b.keys()
    assert common, what
    for k in sorted(common):
        assert _normal(a[k]) == _normal(b[k]), (what, k, a[k], b[k])
    return common


def _first_batch(batch_fn, dataset, schedule, loop_cfg, seed):
    st = schedule.state_at(0)
    batch = loop_cfg.batch_size
    hook = getattr(schedule, "batch_for_step", None)
    if hook is not None and hook(st.step):
        batch = hook(st.step)
    return next(batch_fn(dataset, batch, st.resolution, seed=seed + st.step))


def _compare(name, extra, tmp_path, tiny=True):
    jmod = importlib.import_module(f"pgx.cli.{name}")
    tmod = importlib.import_module(f"pgx_torch.cli.{name}")
    argv = ((TINY + TRAINERS[name][1] if tiny else []) + extra
            + ["--output", str(tmp_path)])
    jargs, jkw = _spy_run(jmod, argv)
    targs, tkw = _spy_run(tmod, argv + ["--device", "cpu"])
    assert tkw.pop("device") == "cpu"
    jg, jd, jtc, jsched, jdata, jloop = jargs
    tg, td, ttc, tsched, tdata, tloop = targs
    _same_fields(tg, jg, "generator")
    _same_fields(td, jd, "discriminator")
    assert _same_fields(ttc, jtc, "train") == {
        f.name for f in dataclasses.fields(ttc)}
    assert _same_fields(tloop, jloop, "loop") == {
        f.name for f in dataclasses.fields(tloop)}
    assert schedule_to_dict(tsched) == jax_schedule_to_dict(jsched)
    assert tkw.keys() == jkw.keys()
    assert tkw["resume_dir"] == jkw["resume_dir"]
    assert tkw["augment_p"] == jkw["augment_p"]
    for key in ("augment_cfg", "ada_cfg"):
        assert (tkw[key] is None) == (jkw[key] is None), key
        if tkw[key] is not None:
            _same_fields(tkw[key], jkw[key], key)
    from pgx.data.pipeline import array_batches as jax_array_batches
    from pgx_torch.data.pipeline import array_batches
    jbatch = _first_batch(jkw.get("batch_fn", jax_array_batches), jdata,
                          jsched, jloop, jloop.seed)
    tbatch = _first_batch(tkw.get("batch_fn", array_batches), tdata, tsched,
                          tloop, tloop.seed)
    np.testing.assert_array_equal(tbatch[0], jbatch[0])
    assert tbatch[0].dtype == jbatch[0].dtype
    assert (tbatch[1] is None) == (jbatch[1] is None)
    if tbatch[1] is not None:
        np.testing.assert_array_equal(tbatch[1], jbatch[1])
        assert tbatch[1].dtype == jbatch[1].dtype
    return tg, tkw


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_defaults_are_pgx_s(tmp_path, name):
    """With no flag but ``--synthetic`` (full widths, pgx's schedules),
    each trainer builds what pgx's builds."""
    _compare(name, ["--synthetic"], tmp_path, tiny=False)


@pytest.mark.parametrize("name,extra", [
    ("train", ["--synthetic"]),
    ("train", ["--synthetic", "--ada", "--ada-length", "100",
               "--dtype", "bfloat16"]),
    ("mnist_train", ["--synthetic", "--tail-iterations", "5",
                     "--full-conv-blocks"]),
    ("mnist_train", ["--path", "sklearn-digits", "--ada-p", "0.3"]),
    ("cifar_train", ["--synthetic", "--gp-mode", "jvp", "--gp-every", "2"]),
    ("cifar_train", ["--path", "sklearn-digits", "--limit-images", "40"]),
    ("proper_cifar_train", ["--synthetic", "--stage-batches", "4:8,8:4",
                            "--fused-g"]),
    ("proper_cifar_train", ["--path", "sklearn-digits", "--ada",
                            "--ada-warp", "gather"]),
    ("conditional_cifar10_wgan_train", ["--synthetic"]),
    ("conditional_cifar10_wgan_train", ["--path", "sklearn-digits",
                                        "--num-classes", "10", "--remat",
                                        "--remat-policy", "d_only"]),
    ("conditional_mnist_wgan_train", ["--synthetic", "--weights-cast",
                                      "once"]),
    ("conditional_mnist_wgan_train", ["--path", "sklearn-digits",
                                      "--num-classes", "10"]),
    ("conditional_proper_wikiart", ["--synthetic", "--equal-embed"]),
    ("conditional_proper_wikiart", ["--synthetic", "--max-step", "7",
                                    "--channels", "16", "--gp-mode", "jvp",
                                    "--steps-per-call", "2"]),
])
def test_trainer_builds_what_pgx_builds(tmp_path, name, extra):
    gcfg, kw = _compare(name, extra, tmp_path)
    if "--max-step" in extra:    # past 128px: the grown plan
        assert gcfg.channels == (16, 16, 16, 16, 8, 4, 2)


def test_train_folder_data_matches_pgx(tmp_path, folder):
    """``train``'s ImageFolderDataset (1.2x resize, random crop, flip)
    through ``folder_batches``, with decode workers and a limit."""
    _, kw = _compare("train", ["--path", folder, "--data-workers", "2",
                               "--limit-images", "12"], tmp_path)
    assert kw["batch_fn"].keywords == {"num_workers": 2}


def test_wikiart_data_matches_pgx(tmp_path, wikiart):
    """``conditional_proper_wikiart``'s metadata-CSV dataset through its
    ``wikiart_batches``, size-filtered at the first stage."""
    root, csv_path = wikiart
    _, kw = _compare("conditional_proper_wikiart",
                     ["--csv", csv_path, "--image-root", root,
                      "--data-workers", "2"], tmp_path)
    assert kw["batch_fn"].func.__module__ == \
        "pgx_torch.cli.conditional_proper_wikiart"


def test_wikiart_batches_match_pgx_over_epochs(wikiart):
    """Several epochs of the size-filtered stream, bit for bit, and the
    refusal of a resolution no image reaches."""
    from pgx.cli.conditional_proper_wikiart import \
        wikiart_batches as jax_batches
    from pgx.data import WikiArtDataset as JaxWikiArt
    from pgx_torch.cli.conditional_proper_wikiart import wikiart_batches
    from pgx_torch.data import WikiArtDataset
    root, csv_path = wikiart
    ours = wikiart_batches(WikiArtDataset(csv_path, root), 4, 16, seed=3)
    theirs = jax_batches(JaxWikiArt(csv_path, root), 4, 16, seed=3)
    for _ in range(7):
        (ti, tl), (ji, jl) = next(ours), next(theirs)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    with pytest.raises(ValueError, match="no WikiArt images"):
        next(wikiart_batches(WikiArtDataset(csv_path, root), 4, 64))


def _rows(trial):
    (log,) = [n for n in os.listdir(trial) if n.startswith("train_log_")]
    with open(os.path.join(trial, log)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_trains_on_the_cpu(tmp_path, name):
    """A real two-stage run: the layout pgx's tests/test_cli_smoke.py
    expects for the same flags (trial_<name>_*, checkpoints written), the
    CSV every 2 iterations, samples at 1 and 4, checkpoints at 1, 4 and
    the end."""
    module = importlib.import_module(f"pgx_torch.cli.{name}")
    trial_name, flags = TRAINERS[name]
    argv = (TINY + flags + ["--synthetic", "--device", "cpu", "--output",
                            str(tmp_path), "--log-every", "2",
                            "--sample-every", "4", "--checkpoint-every",
                            "4"])
    trial = module.main(argv)
    assert os.path.dirname(trial) == str(tmp_path)
    assert os.path.basename(trial).startswith(f"trial_{trial_name}_")
    rows = _rows(trial)
    assert rows[0] == "iter,g,d,grad,alpha"
    iters = [int(r.split(",")[0]) for r in rows[1:]]
    # legacy: 2 stages of total_iter // max_step + 1 = 3; proper: 8px is
    # 2 mini-steps of 8 // 4 after a 4px stage of one
    total = 6
    assert iters == list(range(2, total + 1, 2))
    assert all(np.isfinite([float(v) for v in r.split(",")]).all()
               for r in rows[1:])
    assert sorted(os.listdir(os.path.join(trial, "sample"))) == [
        "001.png", "004.png"]
    names = set(os.listdir(os.path.join(trial, "checkpoint")))
    assert names == {f"{it:03d}_{kind}" for it in (1, 4, total)
                     for kind in ("g.model", "d.model", "state.pt")}
    with open(os.path.join(trial, "timing.json")) as f:
        timing = json.load(f)
    assert [v["resolution"] for v in timing.values()] == [
        8 if "--total-iter" in flags else 4, 16 if "--total-iter" in flags
        else 8, 16 if "--total-iter" in flags else 8]


@pytest.mark.parametrize("flags,match", [
    (["--multihost"], "multihost"),
    (["--checkpoint-backend", "orbax"], "checkpoint_backend"),
    (["--model-parallel", "2"], "model_parallel")])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_refuses_what_is_not_ported(tmp_path, name, flags, match):
    """As the flagship CLI: through ``maybe_init_multihost`` and
    ``LoopConfig``, before anything trains.  ``--checkpoint-backend orbax``
    is ported: every trainer reaches ``train_loop`` with
    ``checkpoint_backend='orbax'``.  ``--multihost`` is ported: without a
    coordinator it raises before anything trains, and with one process it
    initializes nothing and trains on the CPU (two ranks over gloo are in
    tests/test_torch_parallel.py).  ``--model-parallel`` is ported
    (channels mode): with ``--no-mesh`` it raises pgx's ``ValueError``;
    with the mesh every trainer hands ``model_parallel=2`` to the loop,
    which with one process raises pgx's ``ValueError`` for too few devices
    before anything trains (two ranks train in
    tests/test_torch_tp_loop.py)."""
    module = importlib.import_module(f"pgx_torch.cli.{name}")
    if match == "model_parallel":
        with mock.patch.object(_loop_owner(module), "train_loop",
                               side_effect=AssertionError("trained")), \
                pytest.raises(ValueError, match="requires use_mesh=True"):
            module.main(TINY + TRAINERS[name][1] + flags + [
                "--synthetic", "--device", "cpu", "--output",
                str(tmp_path)])
        argv = [a for a in TINY if a != "--no-mesh"] + TRAINERS[name][1] \
            + flags + ["--synthetic", "--device", "cpu", "--output",
                       str(tmp_path)]
        args, _ = _spy_run(module, argv)
        assert (args[5].model_parallel, args[5].model_parallel_mode) == (
            2, "channels")
        with pytest.raises(ValueError, match="model_parallel=2 does not "
                                             "divide the 1 available"):
            module.main(argv)
        return
    if match == "multihost":
        with mock.patch.object(_loop_owner(module), "train_loop",
                               side_effect=AssertionError("trained")), \
                pytest.raises(ValueError, match="coordinator address"):
            module.main(TINY + TRAINERS[name][1] + flags + [
                "--synthetic", "--device", "cpu", "--output",
                str(tmp_path)])
        _, kwargs = _spy_run(module, TINY + TRAINERS[name][1] + flags + [
            "--num-processes", "1", "--synthetic", "--device", "cpu",
            "--output", str(tmp_path)])
        assert kwargs["device"] == "cpu"
        return
    if match == "checkpoint_backend":
        args, _ = _spy_run(module, TINY + TRAINERS[name][1] + flags + [
            "--synthetic", "--device", "cpu", "--output", str(tmp_path)])
        assert args[5].checkpoint_backend == "orbax"
        return
    with mock.patch.object(_loop_owner(module), "train_loop",
                           side_effect=AssertionError("trained")), \
            pytest.raises(NotImplementedError, match=match):
        module.main(TINY + TRAINERS[name][1] + flags + [
            "--synthetic", "--device", "cpu", "--output", str(tmp_path)])
