"""pgx_torch's checkpoint write side against pgx's, on the CPU.

* the ``_g``/``_d`` npz files cross between the packages both ways with the
  same keys, shapes, dtypes and values (bitwise: the same arrays);
* a trial config JSON written by either package reads back through the
  other's ``configs_from_dict`` as equal configs;
* ``grow_params`` equals pgx's bitwise on the same numpy trees, and the
  grown networks pass the port's own equivalence checks;
* the full state (``*_state.pt``) round-trips bitwise: every tensor, the
  Adam counts, ``ada``, ``iteration`` and the random generator's state.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from pgx import checkpoint as jckpt
from pgx.models import generator as jgen
from pgx.models import discriminator as jdisc
from pgx.models import zoo as jzoo
from pgx.train import wgan as jwgan
from pgx_torch import checkpoint as tckpt
from pgx_torch.models import zoo as tzoo
from pgx_torch.train import wgan as twgan

NUM_CLASSES = 3
KW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=4)
DKW = {k: v for k, v in KW.items() if k != "z_dim"}


def _pairs():
    return ((jzoo.conditional_correct_generator(channel=8, **KW),
             jzoo.conditional_correct_discriminator_wgangp(feat_dim=8, **DKW)),
            (tzoo.conditional_correct_generator(channel=8, **KW),
             tzoo.conditional_correct_discriminator_wgangp(feat_dim=8,
                                                           **DKW)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _stepped_state(gcfg, dcfg, seed=0):
    """A port state on the CPU after one training iteration, so that the
    Adam moments, the EMA and the counts are not at their initial values."""
    tc = twgan.TrainConfig()
    state = twgan.init_train_state(gcfg, dcfg, tc, seed=seed, device="cpu")
    rng = torch.Generator().manual_seed(seed)
    res = gcfg.resolution(2)
    real = torch.tanh(torch.randn(4, res, res, 3, generator=rng))
    labels = torch.randint(0, NUM_CLASSES, (4,), generator=rng)
    z, eps = twgan.draw_z_eps(gcfg, 4, rng)
    step = twgan.make_train_step(gcfg, dcfg, tc, step=2, fading=False)
    state, _ = step(state, real, labels, 1.0, z=z, eps=eps)
    state["ada"] = {k: torch.tensor(v, dtype=torch.float32)
                    for k, v in (("p", 0.25), ("sign_sum", 3.0),
                                 ("count", 8.0))}
    state["rng"] = rng
    return state


def test_port_npz_reads_back_in_pgx(tmp_path):
    _, (tg, td) = _pairs()
    state = _stepped_state(tg, td)
    tckpt.save_checkpoint(str(tmp_path), 7, state, full_state=False)
    names = sorted(os.listdir(tmp_path / "checkpoint"))
    assert names == ["007_d.model", "007_g.model"]
    for kind, module in (("g", state["g_ema"]), ("d", state["d"])):
        path = jckpt.latest_checkpoint(str(tmp_path), kind)
        assert jckpt.checkpoint_iteration(path) == 7
        got = jax.device_get(jckpt.load_params(path))
        want = {k: p.detach().numpy()
                for k, p in module.named_parameters()}
        flat = _flat(got)
        assert {k.replace("/", ".") for k in flat} == want.keys()
        for k, v in flat.items():
            ref = want[k.replace("/", ".")]
            assert v.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(v, ref, err_msg=k)


def test_pgx_npz_reads_back_in_port(tmp_path):
    (jg, jd), (tg, td) = _pairs()
    jstate = jax.device_get(jwgan.init_train_state(
        jax.random.PRNGKey(3), jg, jd, jwgan.TrainConfig()))
    jckpt.save_checkpoint(str(tmp_path), 12, jstate, full_state=False)
    g = tckpt.load_params(tckpt.resolve_checkpoint(str(tmp_path), None, "g"))
    d = tckpt.load_params(tckpt.resolve_checkpoint(str(tmp_path), 12, "d"))
    _assert_same_tree(g, jstate["g_ema"])
    _assert_same_tree(d, jstate["d"])
    # and the trees load into the port's modules by name, unchanged
    state = twgan.init_train_state(tg, td, twgan.TrainConfig(), device="cpu")
    state["g"].load_state_dict(
        {k.replace("/", "."): torch.from_numpy(v)
         for k, v in _flat(g).items()}, strict=True)
    _assert_same_tree(tckpt.params_tree(state["g"]), jstate["g_ema"])


def test_params_tree_keeps_each_dtype():
    _, (tg, td) = _pairs()
    state = twgan.init_train_state(tg, td, twgan.TrainConfig(), device="cpu")
    state["d"].double()
    tree = tckpt.params_tree(state["d"])
    assert all(v.dtype == np.float64 for v in _flat(tree).values())
    tree = tckpt.params_tree(state["g_ema"])
    assert all(v.dtype == np.float32 for v in _flat(tree).values())


@pytest.mark.parametrize("writer", ["port", "pgx"])
def test_config_json_crosses_packages(tmp_path, writer):
    (jg, jd), (tg, td) = _pairs()
    extra = {"batch_size": 4, "seed": 1, "augment": None,
             "schedule": {"kind": "proper", "images_seen_per_mini_step": 2,
                          "batch_size": 1, "max_step": 4, "init_step": 2}}
    jtc = jwgan.TrainConfig(gp_every=2, learning_rate=3e-4)
    ttc = twgan.TrainConfig(gp_every=2, learning_rate=3e-4)
    if writer == "port":
        tckpt.save_config(str(tmp_path), tg, td, ttc, extra=extra,
                          postfix="x")
    else:
        jckpt.save_config(str(tmp_path), jg, jd, jtc, extra=extra,
                          postfix="x")
    assert os.listdir(tmp_path) == ["train_config_x.json"]
    cfg = tckpt.load_config(str(tmp_path))
    assert cfg == jckpt.load_config(str(tmp_path))
    assert {k: cfg[k] for k in extra} == extra
    assert tckpt.configs_from_dict(cfg) == (tg, td, ttc)
    assert jckpt.configs_from_dict(cfg) == (jg, jd, jtc)
    for t, j in zip((tg, td, ttc), (jg, jd, jtc)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_configs_from_dict_refuses_unported_train_options(tmp_path):
    """Once refused, the step's variants now load: a trial pgx saved with
    remat, its policy, the jvp penalty and weights_cast='once' gives the
    same TrainConfig."""
    (jg, jd), _ = _pairs()
    jtc = jwgan.TrainConfig(remat=True, remat_policy="convs", gp_mode="jvp",
                            weights_cast="once", gp_every=4, fused_g=True)
    jckpt.save_config(str(tmp_path), jg, jd, jtc)
    _, _, ttc = tckpt.configs_from_dict(tckpt.load_config(str(tmp_path)))
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)


def _grown_pair(max_step, module):
    return module.conditional_correct_grown(max_step, z_dim=8, channel=8,
                                            num_classes=NUM_CLASSES)


@pytest.mark.parametrize("decay", [0.0, 0.3])
def test_grow_params_matches_pgx(decay):
    small_j, big_j = _grown_pair(4, jzoo), _grown_pair(5, jzoo)
    small_t, big_t = _grown_pair(4, tzoo), _grown_pair(5, tzoo)
    key_s, key_b = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    trees = {}
    for name, (cfg_j, key) in (("small", (small_j, key_s)),
                               ("big", (big_j, key_b))):
        trees[name] = (
            jax.device_get(jgen.init_generator(key, cfg_j[0])),
            jax.device_get(jdisc.init_discriminator(key, cfg_j[1])))
    for k in (0, 1):
        got = tckpt.grow_params(trees["small"][k], trees["big"][k], decay)
        want = jax.device_get(jckpt.grow_params(
            trees["small"][k], trees["big"][k], decay))
        _assert_same_tree(got, want)
    if decay:
        return
    # the grown networks reproduce the small ones at the shared step
    rng = np.random.RandomState(0)
    z = rng.randn(4, 8).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, 4)
    grown_g = tckpt.grow_params(trees["small"][0], trees["big"][0])
    tckpt.assert_grow_equivalence(trees["small"][0], small_t[0], grown_g,
                                  big_t[0], z, labels, step=4, device="cpu")
    res = small_t[0].resolution(4)
    img = np.tanh(rng.randn(4, res, res, 3)).astype(np.float32)
    grown_d = tckpt.grow_params(trees["small"][1], trees["big"][1])
    tckpt.assert_grow_equivalence_d(trees["small"][1], small_t[1], grown_d,
                                    big_t[1], img, labels, step=4,
                                    device="cpu")
    with pytest.raises(AssertionError):
        tckpt.assert_grow_equivalence(trees["small"][0], small_t[0],
                                      trees["big"][0], big_t[0], z, labels,
                                      step=4, device="cpu")


def test_grow_params_refuses_shape_mismatch():
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.grow_params({"a": np.zeros(3)}, {"a": np.zeros(4)})


def _state_tensors(state):
    out = {}
    for k in ("g", "d", "g_ema"):
        for n, p in state[k].named_parameters():
            out[f"{k}.{n}"] = p.detach()
    for k in ("opt_g", "opt_d"):
        for m in ("mu", "nu"):
            for n, t in state[k][m].items():
                out[f"{k}.{m}.{n}"] = t
    for n, t in state["ada"].items():
        out[f"ada.{n}"] = t
    return out


def test_full_state_round_trips_bitwise(tmp_path):
    _, (tg, td) = _pairs()
    state = _stepped_state(tg, td, seed=0)
    torch.rand(5, generator=state["rng"])        # a generator mid-stream
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    assert sorted(os.listdir(tmp_path / "checkpoint")) == [
        "001_d.model", "001_g.model", "001_state.pt"]
    other = twgan.init_train_state(tg, td, twgan.TrainConfig(), seed=5,
                                   device="cpu")
    other["rng"] = torch.Generator().manual_seed(5)
    g_params = list(other["g"].parameters())
    loaded = tckpt.load_state(str(tmp_path / "checkpoint" / "001_state.pt"),
                              other)
    assert loaded is other
    # the modules keep their parameter objects (the optimizer's view)
    assert all(a is b for a, b in zip(g_params, other["g"].parameters()))
    want, got = _state_tensors(state), _state_tensors(other)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert [p.requires_grad for p in other["g"].parameters()] == [
        p.requires_grad for p in state["g"].parameters()]
    for k in ("opt_g", "opt_d"):
        assert other[k]["count"] == state[k]["count"] == 1
    assert other["iteration"] == state["iteration"] == 1
    assert torch.equal(other["rng"].get_state(), state["rng"].get_state())
    assert torch.equal(torch.rand(8, generator=other["rng"]),
                       torch.rand(8, generator=state["rng"]))


def test_full_state_refuses_other_parameters(tmp_path):
    _, (tg, td) = _pairs()
    state = _stepped_state(tg, td)
    path = str(tmp_path / "s.pt")
    tckpt.save_state(path, state)
    small_g = tzoo.conditional_correct_generator(channel=16, **KW)
    other = twgan.init_train_state(small_g, td, twgan.TrainConfig(),
                                   device="cpu")
    with pytest.raises(RuntimeError):
        tckpt.load_state(path, other)
