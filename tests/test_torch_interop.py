"""The reference ``.model`` import and export of pgx_torch against pgx's, on
the CPU, for all seven reference families.

pgx's parameters (its own init, tiny widths) go through pgx's
``export_checkpoint_pair`` into reference ``.model`` files (the reference
tree is not needed: pgx's exporter writes the reference's state-dict
schema, which tests/test_torch_export.py holds against the live reference
classes).  The port's importer must read them to exactly pgx's arrays, and
the port's exporter must write exactly pgx's tensors.  Then the two CLIs
on trials, the family inference and the two zoo factories added with them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from pgx.checkpoint import torch_export as jexport
from pgx.checkpoint import torch_import as jimport
from pgx.models import init_discriminator as jinit_d
from pgx.models import init_generator as jinit_g
from pgx.models import zoo as jzoo
from pgx_torch import checkpoint as tckpt
from pgx_torch.checkpoint import torch_export as texport
from pgx_torch.checkpoint import torch_import as timport
from pgx_torch.models import zoo as tzoo

NUM_CLASSES = 3
REF_CFGS = {
    "legacy": {"generator": {"input_code_dim": 8, "in_channel": 16},
               "discriminator": {"feat_dim": 16}, "max_step": 3},
    "proper": {"generator": {"input_code_dim": 8, "in_channel": 8},
               "discriminator": {"feat_dim": 8}, "max_step": 3},
    "mnist": {"generator": {"input_code_dim": 8, "in_channel": 8,
                            "use_mnist_conv_blocks": False},
              "discriminator": {"feat_dim": 8,
                                "use_mnist_conv_blocks": False}},
}
FAMILIES = {
    "legacy": "legacy", "conditional_legacy": "legacy", "proper": "proper",
    "conditional_proper": "proper", "conditional_proper_ada": "proper",
    "mnist": "mnist", "conditional_mnist": "mnist"}


def _pgx_pair(family, seed=0):
    gcfg, dcfg = jimport.FAMILIES[family](REF_CFGS[FAMILIES[family]],
                                          NUM_CLASSES)
    g = jax.tree.map(np.asarray, jinit_g(jax.random.PRNGKey(seed), gcfg))
    d = jax.tree.map(np.asarray, jinit_d(jax.random.PRNGKey(seed + 1),
                                         dcfg))
    return gcfg, dcfg, g, d


def _flat(tree):
    return tckpt._flatten(tree)


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_and_export_equal_pgx(tmp_path, family):
    jg, jd, g, d = _pgx_pair(family)
    tg, td = timport.FAMILIES[family](REF_CFGS[FAMILIES[family]],
                                      NUM_CLASSES)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    gp, dp = str(tmp_path / "1_g.model"), str(tmp_path / "1_d.model")
    jexport.export_checkpoint_pair(g, d, jg, jd, g_path=gp, d_path=dp)
    # import: the port reads pgx's files to pgx's own arrays
    want = [jax.tree.map(np.asarray, t)
            for t in jimport.import_checkpoint_pair(gp, dp, jg, jd)]
    got = timport.import_checkpoint_pair(gp, dp, tg, td)
    for gt, wt in zip(got, want):
        _assert_trees_equal(gt, wt)
    _assert_trees_equal(got[0], g)
    # export: the port writes pgx's tensors, key for key
    for part, (jfn, tfn, params, cfg) in {
            "g": (jexport.generator_state_dict_from_params,
                  texport.generator_state_dict_from_params, g, jg),
            "d": (jexport.discriminator_state_dict_from_params,
                  texport.discriminator_state_dict_from_params, d, jd),
    }.items():
        want_sd = jfn(params, cfg)
        got_sd = tfn(params, tg if part == "g" else td)
        assert got_sd.keys() == want_sd.keys()
        for k in want_sd:
            assert got_sd[k].dtype == np.float32 and got_sd[k].flags[
                "C_CONTIGUOUS"]
            np.testing.assert_array_equal(got_sd[k], want_sd[k], err_msg=k)
    tp = str(tmp_path / "2_g.model")
    texport.export_checkpoint_pair(g, None, tg, td, g_path=tp)
    written = torch.load(tp, weights_only=True)
    assert written.keys() == torch.load(gp, weights_only=True).keys()
    # the reference's config sections and the family's name
    assert texport.infer_family(tg, td) == jexport.infer_family(jg, jd)
    assert texport.reference_config_from_configs(tg, td) == \
        jexport.reference_config_from_configs(jg, jd)
    # what the shapes give when no config JSON is there
    gsd = timport.load_torch_state_dict(gp)
    dsd = timport.load_torch_state_dict(dp)
    assert timport.infer_ref_config(gsd, dsd) == \
        jimport.infer_ref_config(gsd, dsd)
    assert timport.infer_ref_config(gsd) == jimport.infer_ref_config(gsd)


def _port_trial(root, family="conditional_proper", iters=(4, 8)):
    """A trial as the port's checkpoint module writes it (pgx's parameters
    in it), with a schedule block."""
    from pgx_torch.train import TrainConfig
    jg, jd, g, d = _pgx_pair(family)
    tg, td = timport.FAMILIES[family](REF_CFGS[FAMILIES[family]],
                                      NUM_CLASSES)
    trial = str(root / "trial")
    tckpt.save_config(trial, tg, td, TrainConfig(),
                      extra={"batch_size": 4, "schedule": {
                          "kind": "proper", "images_seen_per_mini_step": 2,
                          "batch_size": 1, "max_step": 3, "init_step": 1}},
                      postfix="t")
    os.makedirs(os.path.join(trial, "checkpoint"))
    for n, it in enumerate(iters):
        for kind, tree in (("g", g), ("d", d)):
            tckpt.save_params(os.path.join(
                trial, "checkpoint", tckpt.checkpoint_name(it, kind)),
                jax.tree.map(lambda a: a * (1 + n), tree))
    return trial, tg, td


def test_export_then_import_cli_round_trip(tmp_path, capsys):
    """export_torch_checkpoint -> import_checkpoint (--sample on the CPU):
    every parameter comes back byte for byte, the schedule rides along,
    pgx's importer reads the port's export to the same arrays, and a
    single file imports with the dims inferred from its shapes."""
    from pgx_torch.cli import export_torch_checkpoint, import_checkpoint
    trial, tg, td = _port_trial(tmp_path)
    ref = str(tmp_path / "ref")
    export_torch_checkpoint.main(["--trial", trial, "--out", ref])
    with open(os.path.join(ref, "train_config_exported.json")) as f:
        ref_cfg = json.load(f)
    assert ref_cfg["schedule"] == tckpt.load_config(trial)["schedule"]
    assert sorted(os.listdir(os.path.join(ref, "checkpoint"))) == [
        "004_d.model", "004_g.model", "008_d.model", "008_g.model"]
    back = str(tmp_path / "back")
    import_checkpoint.main(["--trial", ref, "--family", "conditional_proper",
                            "--num-classes", str(NUM_CLASSES), "--out",
                            back, "--sample", "--device", "cpu"])
    assert "-> " in capsys.readouterr().out
    cfg = tckpt.load_config(back)
    assert cfg["schedule"] == ref_cfg["schedule"]
    assert cfg["reference_family"] == "conditional_proper"
    bg, bd, _ = tckpt.configs_from_dict(cfg)
    assert (bg, bd) == (tg, td)
    for it in (4, 8):
        for kind in ("g", "d"):
            name = tckpt.checkpoint_name(it, kind)
            _assert_trees_equal(
                tckpt.load_params(os.path.join(back, "checkpoint", name)),
                tckpt.load_params(os.path.join(trial, "checkpoint", name)))
        png = os.path.join(back, "sample", f"{it:03d}_imported.png")
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    jg_, _ = jimport.import_checkpoint_pair(
        os.path.join(ref, "checkpoint", "008_g.model"), None, tg, td)
    _assert_trees_equal(jax.tree.map(np.asarray, jg_), tckpt.load_params(
        os.path.join(trial, "checkpoint", "008_g.model")))
    single = str(tmp_path / "single")
    import_checkpoint.main([
        "--g-model", os.path.join(ref, "checkpoint", "004_g.model"),
        "--family", "conditional_proper", "--num-classes",
        str(NUM_CLASSES), "--out", single, "--sample", "--device", "cpu"])
    sg, _, _ = tckpt.configs_from_dict(tckpt.load_config(single))
    assert (sg.z_dim, sg.channels[0]) == (tg.z_dim, tg.channels[0])
    assert os.listdir(os.path.join(single, "checkpoint")) == ["004_g.model"]
    assert os.listdir(os.path.join(single, "sample")) == [
        "004_imported.png"]


@pytest.mark.parametrize("kw", [
    {}, dict(z_dim=8, num_classes=4, channel=16, max_step=3, tanh=False,
             pixel_norm=False, dtype="bfloat16")])
def test_new_zoo_factories_equal_pgx(kw):
    assert dataclasses.asdict(tzoo.conditional_generator(**kw)) == \
        dataclasses.asdict(jzoo.conditional_generator(**kw))
    kw = {k: v for k, v in kw.items() if k != "max_step"}
    for blocks in (True, False):
        assert dataclasses.asdict(tzoo.mnist_conditional_generator(
            use_mnist_conv_blocks=blocks, **kw)) == dataclasses.asdict(
            jzoo.mnist_conditional_generator(use_mnist_conv_blocks=blocks,
                                             **kw))
