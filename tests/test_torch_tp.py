"""pgx_torch.parallel.tp against pgx/parallel/tp.py on the CPU: the leaf
rule, the blocks, the grid.

* **The leaf rule**: the port's ``state_shardings`` against pgx's, leaf by
  leaf, for G, D, G_ema, ``opt_g`` and ``opt_d`` of the tiny f64
  conditional "proper" pair (tests/test_torch_ddp.py's; channel 8), at
  model axes 2, 4 and 3 (where only the 3-channel to_rgb heads divide),
  and on a toy state with an indivisible trailing dim, a float scalar and
  an integer leaf (tests/test_tp.py's model).
* **The blocks**: after ``shard_state`` rank m's block of every leaf equals
  ``np.asarray`` of pgx's addressable shard on the device at model index m,
  bit for bit, at model axes 2 and 4; each rank holds the replicated leaves
  and 1/n_model of the sharded ones, counted in bytes.  Two gloo ranks
  (tests/torch_ddp_worker.py, case ``tp_units``) gather the state back:
  ``gather_state(shard_state(s)) == s`` bit for bit.
* **The grid**: ``make_mesh_2d`` and ``make_mesh_2d_for_batch`` at world 1
  here and at world 2 in the ranks: shape, the rank layout (model axis
  minor), the subgroups, and each error with pgx's message where pgx
  raises the same (too few devices; a model axis that does not divide the
  devices; one spanning hosts, pgx under a patched ``process_count``).
  The port's refusal of a batch the world does not divide is its own (pgx
  shrinks the data axis inside one process).  ``use_spatial_sharding``
  against pgx's at resolutions 4-1024 and model axes 1-8;
  ``spatial_batch_sharding`` gives a rank its rows of H.
* ``check_replica_consistency(mesh=)`` passes on the sharded state and
  names a replicated leaf one rank changed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.parallel import tp as jtp
from pgx_torch import parallel as tpar
from pgx_torch.models import zoo as tzoo
from pgx_torch.parallel import tp
from pgx_torch.train import wgan as twgan
from tests.test_torch_ddp import DKW, GKW, _initial_state, _plain
from tests.test_torch_parallel import run_ranks

TG = tzoo.conditional_correct_generator(**GKW)
TD = tzoo.conditional_correct_discriminator_wgangp(**DKW)


def _pgx_names(shardings):
    """pgx's ``state_shardings`` as ``{port leaf name: spec tuple}``:
    optax's ``(ScaleByAdamState, EmptyState)`` tuple position dropped."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    for path, sh in leaves:
        parts = []
        for k in path:
            if isinstance(k, jax.tree_util.SequenceKey):
                continue
            parts.append(str(getattr(k, "key", getattr(k, "name", k))))
        out[".".join(parts)] = tuple(sh.spec)
    return out


def _port_state(jstate):
    return twgan.train_state_from_jax(TG, TD, twgan.TrainConfig(),
                                      jax.device_get(jstate), "cpu")


@pytest.fixture(scope="module")
def jstate():
    return _initial_state(5)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 4), (1, 3)])
def test_leaf_rule_equals_pgx_leaf_by_leaf(jstate, n_data, n_model):
    want = _pgx_names(jtp.state_shardings(jstate,
                                          jtp.make_mesh_2d(n_data, n_model)))
    got = tp.state_shardings(_port_state(jstate),
                             tp.Mesh2D(n_data, n_model))
    nets = ("g.", "d.", "g_ema.", "opt_g.", "opt_d.")
    want_nets = {k: v for k, v in want.items() if k.startswith(nets)}
    got_nets = {k: v for k, v in got.items() if k.startswith(nets)}
    assert got_nets == want_nets
    # the same for the shared leaves elsewhere in the state
    for k in ("iteration", "ada.p", "ada.sign_sum", "ada.count"):
        assert got[k] == want[k] == (), k
    sharded = [k for k, v in got_nets.items() if v]
    if n_model == 3:      # 8 channels: only the 3-channel heads divide
        assert sharded and all("to_rgb" in k for k in sharded)
    else:
        assert not any("to_rgb" in k for k in sharded)
        assert "g.blocks.8.conv1.w" in sharded
        assert "opt_d.nu.blocks.8.conv1.w" in sharded


def test_leaf_rule_on_indivisible_and_scalar_leaves():
    """tests/test_tp.py's rules on a toy state: an indivisible trailing
    dim, a float scalar and integers replicate."""
    arrays = {"w": np.zeros((4, 6), np.float32),
              "v": np.zeros((5,), np.float32),
              "s": np.float32(1.0) * np.ones((), np.float32),
              "i": np.zeros((8,), np.int32),
              "b": np.zeros((3, 8), np.float64)}
    for n_model in (2, 4):
        want = _pgx_names(jtp.state_shardings(
            {k: jnp.asarray(v) for k, v in arrays.items()},
            jtp.make_mesh_2d(1, n_model)))
        got = tp.state_shardings({k: torch.from_numpy(np.asarray(v))
                                  for k, v in arrays.items()},
                                 tp.Mesh2D(1, n_model))
        assert got == want, n_model
    assert got["b"] == (None, "model") and got["w"] == ()
    assert got["s"] == got["i"] == got["v"] == ()


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 4)])
def test_blocks_equal_pgx_addressable_shards(jstate, n_data, n_model):
    mesh = jtp.make_mesh_2d(n_data, n_model)
    placed = jtp.shard_state(mesh, jstate)
    want = {}
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    names = list(_pgx_names(jtp.state_shardings(jstate, mesh)))
    assert len(names) == len(leaves)
    for name, (_, arr) in zip(names, leaves):
        want[name] = arr
    full = tp.resident_bytes(_port_state(jstate))
    for m in range(n_model):
        device = mesh.devices[0, m]
        state = tp.shard_state(tp.Mesh2D(n_data, n_model, 0, m),
                               _port_state(jstate))
        seen = 0
        for name, leaf in tpar.distributed.named_state_leaves(state):
            if not name.startswith(("g.", "d.", "g_ema.", "opt_")):
                continue
            if not isinstance(leaf, torch.Tensor):
                continue
            arr = want[name]
            (shard,) = [s for s in arr.addressable_shards
                        if s.device == device]
            np.testing.assert_array_equal(leaf.detach().numpy(),
                                          np.asarray(shard.data),
                                          err_msg=name, strict=True)
            seen += 1
        assert seen == sum(1 for k in want if k.startswith(
            ("g.", "d.", "g_ema.", "opt_")) and not k.endswith("count"))
        # at rest: the replicated bytes whole, the sharded ones 1/n_model
        specs = tp.state_shardings(state, tp.Mesh2D(n_data, n_model))
        sharded_full = sum(np.asarray(want[k]).nbytes
                           for k, v in specs.items() if v)
        assert tp.resident_bytes(state) == full - sharded_full + \
            sharded_full // n_model


def test_mesh_at_world_1_raises_pgx_errors():
    one = jax.devices()[:1]
    for port, pgx in (
            (lambda: tp.make_mesh_2d(1, 2),
             lambda: jtp.make_mesh_2d(1, 2, devices=one)),
            (lambda: tp.make_mesh_2d_for_batch(8, 2),
             lambda: jtp.make_mesh_2d_for_batch(8, 2, devices=one))):
        with pytest.raises(ValueError) as want:
            pgx()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)
    mesh = tp.make_mesh_2d_for_batch(8, 1)
    assert (mesh.shape, mesh.world, mesh.rank, mesh.model_group) == (
        {"data": 1, "model": 1}, 1, 0, None)
    assert tpar.make_mesh_2d is tp.make_mesh_2d


def test_use_spatial_sharding_equals_pgx_and_spatial_raises():
    for res in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
        for n_model in range(1, 9):
            assert tp.use_spatial_sharding(res, n_model) == \
                jtp.use_spatial_sharding(res, n_model), (res, n_model)
    # the rank's rows of H (tests/test_torch_spatial.py holds the
    # placement against pgx's)
    place = tpar.spatial_batch_sharding(tp.Mesh2D(1, 2, 0, 1, mode="spatial"))
    assert (place.batch_rows(4), place.height_rows(8)) == (slice(0, 4),
                                                           slice(4, 8))


@pytest.fixture(scope="module")
def units(jstate):
    """One launch of two ranks; the rank that differs changes a replicated
    leaf of D's second moment (the first whose trailing dim is odd)."""
    perturb = next(n for n, t in _port_state(jstate)["opt_d"]["nu"].items()
                   if t.shape[-1] % 2)
    inp = {"gkw": GKW, "dkw": DKW, "state": _plain(jstate),
           "perturb": perturb}
    return inp, run_ranks("tp_units", inp)


def test_grid_layout_and_subgroups_at_world_2(units):
    _, outs = units
    for r, o in enumerate(outs):
        assert o["grid"] == (1, 2, 0, r, r)
        assert o["model_group"] == [0, 1]
        assert o["data_group"] == [r]
        assert o["for_batch"] == {"data": 1, "model": 2}


def test_grid_errors_at_world_2(units, monkeypatch):
    _, outs = units
    two = jax.devices()[:2]
    with pytest.raises(ValueError) as too_few:
        jtp.make_mesh_2d(2, 2, devices=two)
    with pytest.raises(ValueError) as indivisible:
        jtp.make_mesh_2d_for_batch(8, 3, devices=two)
    monkeypatch.setattr(jtp.jax, "process_count", lambda: 2)
    monkeypatch.setattr(jtp.jax, "local_device_count", lambda: 1)
    with pytest.raises(ValueError) as spans:
        jtp.make_mesh_2d(1, 2, devices=two)
    for o in outs:
        err = o["errors"]
        assert err["too_few"] == str(too_few.value)
        assert err["indivisible_model"] == str(indivisible.value)
        assert err["model_axis_spans_hosts"] == str(spans.value)
        assert "multi-host" in err["batch"] and "batch_size=3" in err["batch"]
        assert "cannot leave a process off the mesh" in err["off_the_mesh"]


def test_gather_of_the_blocks_is_the_state_bit_for_bit(units, jstate):
    inp, outs = units
    plain = inp["state"]
    for r, o in enumerate(outs):
        st = o["gathered"]
        for net in ("g", "d", "g_ema"):
            want = {n: np.asarray(a) for n, a in
                    tpar.distributed.named_state_leaves(
                        _port_state(jstate)[net].state_dict())}
            assert st[net].keys() == want.keys()
            for n, a in want.items():
                np.testing.assert_array_equal(st[net][n], a, strict=True)
        for opt in ("opt_g", "opt_d"):
            assert st[opt]["count"] == plain[opt]["count"]
            for mom in ("mu", "nu"):
                port = _port_state(jstate)[opt][mom]
                for n, t in port.items():
                    np.testing.assert_array_equal(st[opt][mom][n],
                                                  t.numpy(), strict=True)
        whole, rest = o["bytes"]
        assert rest < 0.55 * whole
        assert o["shardings"]["g.blocks.8.conv1.w"] == (None, None, None,
                                                        "model")


def test_consistency_over_the_grid(units):
    inp, outs = units
    for o in outs:
        assert o["perturbed"] is not None
        assert f"opt_d.nu.{inp['perturb']}" in o["perturbed"]
