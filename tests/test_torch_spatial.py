"""Spatial model parallelism's units (pgx/parallel/tp.py's ``spatial``
mode): every image split over H across the model axis.

Without ranks: the placement ``spatial_batch_sharding`` gives each rank
(pgx's ``P('data', 'model')``, read from pgx's ``devices_indices_map`` on
the conftest's virtual CPU devices), and the loop's per-stage choice
(``_stage_rows``): a stage that ``use_spatial_sharding`` refuses (4px at
model 8: at model 2 every stage height ``4 * 2**k`` splits, so no stage
falls back) takes batch-only placement, each rank its rows of the world.

One launch of four gloo ranks (tests/torch_ddp_worker.py, case
``spatial``), f64 unless named:

* on the (1, 4) grid (one row a rank at 4px) and the (2, 2) grid (each
  data position's two model ranks split its images), against the same
  functions of whole images held by every rank: ``halo_exchange`` with
  each fill (zeros, the edge row, none; one and two rows) forward,
  backward, double backward and ``jvp``; ``gather_rows`` and
  ``split_rows`` (the gather's backward is ``n_model`` times the rows'
  gradient: every rank differentiates the same whole, the collectives'
  convention); a 3x3 conv on cuDNN's route (input and summed weight
  gradients) and on kernel C's (its plain version here, f32, haloed
  tiles), ``upsample2x`` and ``downsample2x``, each with the rows at the
  true image edges and at the cuts between ranks checked by name; G and
  D of the tiny pair with the fading blend; the gloo form of every
  collective against the NCCL form (run on gloo), bit for bit.
* the port's step on the (1, 4) grid against pgx's step on
  ``make_mesh_2d(1, 4)`` with the images placed by pgx's
  ``spatial_batch_sharding``: the reverse penalty, tests/test_torch_ddp.py's
  tiny f64 pair at step 2 (8px, two rows a rank), batch 4, pgx's draws;
  metrics 1e-9, parameters and Adam's moments 1e-9 of each tensor's
  largest entry (``check_variant``).  tests/test_torch_spatial_step.py
  holds the (1, 2) grid's variants.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pgx import parallel as jpar
from pgx.parallel import tp as jtp
from pgx.train import wgan as jwgan
from pgx_torch.models.discriminator import init_discriminator
from pgx_torch.models.generator import init_generator
from pgx_torch.parallel import tp
from pgx_torch.train import loop as tloop
from tests.test_torch_ddp import (DKW, GKW, JD, JG, STEP, _batch, _draws,
                                  _initial_state, _plain, check_variant)
from tests.test_torch_parallel import start_ranks

TOL = 1e-12          # f64 against whole images
TOL32 = 1e-5         # kernel C's route, f32


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.astype(np.float64)
            for k, v in tree.items()}


def run_spatial(world, variants, units=True):
    """``variants`` through pgx's step on ``make_mesh_2d(1, world)`` with
    the images spatially placed and through the port's ranks on the same
    grid (one launch, with the units when asked): ``(the ranks' outputs,
    {variant: (pgx's metrics per iteration, pgx's final state)})``.  A
    variant: ``tc`` (the port's TrainConfig), ``pgx_tc`` (pgx's, where
    remat is left out to share a compile), ``ada``, ``iterations``."""
    from pgx.augment import AdaConfig as JAdaConfig
    from pgx.augment import pipe as jpipe
    from pgx_torch.models import zoo
    from tests.test_torch_ddp import ADA
    inp = {"gkw": GKW, "dkw": DKW, "variants": {}}
    if units:
        rng = np.random.RandomState(5)
        gcfg = zoo.conditional_correct_generator(**GKW)
        dcfg = zoo.conditional_correct_discriminator_wgangp(**DKW)
        inp["units"] = {
            "x": rng.randn(2, 8, 6, 8), "gkw": GKW, "dkw": DKW,
            "g": _f64(init_generator(gcfg, 3)),
            "d": _f64(init_discriminator(dcfg, 4)),
            "z": rng.randn(4, GKW["z_dim"]),
            "labels": rng.randint(0, 3, 4).astype(np.int64), "step": STEP}
    mesh = jpar.make_mesh_2d(1, world)
    res = JG.resolution(STEP)
    states = {}
    for name, var in variants.items():
        seed = 31 + len(states)
        jstate = _initial_state(seed, ada_p=0.6 if var["ada"] else 0.0)
        its, rng = [], jstate["rng"]
        for i in range(var["iterations"]):
            # pgx's draws: its step advances the key to split(key, 6)[0]
            real, labels = _batch(seed=80 + 7 * seed + i)
            z, eps, aug = _draws(dict(jstate, rng=rng), var["ada"], res)
            rng = jax.random.split(rng, 6)[0]
            its.append(dict(real=real, labels=labels, z=z, eps=eps, aug=aug,
                            apply_gp=True))
        inp["variants"][name] = dict(
            tc=var["tc"], ada=ADA if var["ada"] else None, step=STEP,
            state=_plain(jstate), iterations=its)
        states[name] = jstate
    # the ranks run while pgx runs here
    finish = start_ranks("spatial", inp, world, timeout=300)
    want, steps = {}, {}
    for name, var in variants.items():
        kw = {}
        if var["ada"]:
            kw = dict(augment_cfg=jpipe.bgc_config(),
                      ada_cfg=JAdaConfig(**ADA))
        pgx_tc = var.get("pgx_tc", var["tc"])
        key = (tuple(sorted(pgx_tc.items())), var["ada"])
        if key not in steps:
            steps[key] = jwgan.make_train_step(
                JG, JD, jwgan.TrainConfig(**pgx_tc), step=STEP,
                fading=False, donate=False, **kw)
        jstate, jmetrics = jpar.replicate(mesh, states[name]), []
        for it in inp["variants"][name]["iterations"]:
            r_dev = jax.device_put(jnp.asarray(it["real"]),
                                   jtp.spatial_batch_sharding(mesh))
            l_dev = jpar.shard_batch(mesh, jnp.asarray(it["labels"]))
            jstate, m = steps[key](jstate, r_dev, l_dev,
                                   jnp.asarray(1.0, jnp.float64))
            jmetrics.append({k: float(v) for k, v in m.items()})
        want[name] = (jmetrics, jax.device_get(jstate))
    return finish(), want


@pytest.fixture(scope="module")
def spatial4():
    return run_spatial(4, {"reverse": dict(tc={}, ada=False,
                                           iterations=1)})


GRIDS = [(1, 4), (2, 2)]
HALOS = ["halo_zero_1", "halo_edge_1", "halo_none_1", "halo_zero_2"]


def _rank_units(spatial4, grid):
    return [o["units"][grid] for o in spatial4[0]]


def _by_kind(per_rank, tol):
    """Every rank's errors by row class within ``tol``, and the rows at the
    true edges and at the cuts among them."""
    merged = {}
    for errs in per_rank:
        for kind, err in errs.items():
            merged[kind] = max(merged.get(kind, 0.0), err)
    assert {"edge", "cut"} <= set(merged), merged
    assert max(merged.values()) <= tol, merged


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 4), (4, 2), (1, 8)])
def test_spatial_batch_sharding_equals_pgx_placement(n_data, n_model):
    mesh = jpar.make_mesh_2d(n_data, n_model)
    shape = (8, 32, 32, 3)
    indices = jtp.spatial_batch_sharding(mesh).devices_indices_map(shape)
    x = np.arange(np.prod(shape)).reshape(shape)
    for d in range(n_data):
        for m in range(n_model):
            place = tp.spatial_batch_sharding(
                tp.Mesh2D(n_data, n_model, d, m, mode="spatial"))
            want = indices[mesh.devices[d, m]]
            got = place.index(shape)
            assert [(s.start or 0, s.stop or n) for s, n in
                    zip(got, shape)] == [
                (s.start or 0, s.stop if s.stop is not None else n)
                for s, n in zip(want, shape)], (d, m)
            assert np.array_equal(place(x), x[want])
    with pytest.raises(ValueError, match="does not split"):
        tp.spatial_batch_sharding(tp.Mesh2D(1, 3, mode="spatial")
                                  ).height_rows(32)


def test_the_loop_falls_back_where_the_stage_is_shorter_than_the_axis():
    """pgx's gate per stage; the loop's placement of each rank at it."""
    for res in (4, 8, 16, 32, 64, 128, 256, 512):
        for n in (2, 4, 8):
            mesh = tp.Mesh2D(1, n, 0, n - 1, mode="spatial")
            assert tp.spatial_active(mesh, res) == \
                jtp.use_spatial_sharding(res, n), (res, n)
    # model 2: every stage splits
    assert all(tp.spatial_active(tp.Mesh2D(2, 2, mode="spatial"), 4 << k)
               for k in range(8))
    mesh = tp.Mesh2D(2, 8, 1, 3, mode="spatial")       # rank 11 of 16
    # 4px at model 8: batch-only, this rank's rows of the world, its seed
    assert tloop._stage_rows(mesh, 32, 4, 16, 11) == (2, 11, None, 16)
    # 8px: the rows of data position 1 (its stream), H rows 3 of 8
    assert tloop._stage_rows(mesh, 32, 8, 16, 11) == (16, 1, slice(3, 4), 2)
    assert tloop._stage_rows(mesh, 32, 64, 16, 11) == (16, 1,
                                                       slice(24, 32), 2)
    # channels mode and no grid: every stage its rows of the world
    assert tloop._stage_rows(tp.Mesh2D(2, 8, 1, 3), 32, 64, 16, 11) == (
        2, 11, None, 16)
    assert tloop._stage_rows(None, 8, 64, 1, 0) == (8, 0, None, 1)
    with pytest.raises(ValueError, match="not divisible"):
        tloop._stage_rows(None, 6, 64, 4, 0)


def test_mesh_modes():
    assert tp.Mesh2D(1, 2).mode == "channels"
    assert tp.make_mesh_2d(1, 1, mode="spatial").mode == "spatial"
    with pytest.raises(ValueError, match="unknown model_parallel_mode"):
        tp.Mesh2D(1, 2, mode="rows")
    with pytest.raises(ValueError, match="unknown model_parallel_mode"):
        tp.make_mesh_2d(1, 1, mode="rows")
    # the state stays whole in spatial mode
    mesh = tp.Mesh2D(1, 2, mode="spatial")
    state = {"x": 1}
    assert tp.shard_state(mesh, state) is state
    assert tp.gather_state(mesh, state) is state


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", HALOS)
def test_halo_exchange_against_whole_images(spatial4, grid, name):
    n = grid[1]
    fill, rows = name.split("_")[1], int(name.split("_")[2])
    units = _rank_units(spatial4, grid)
    for r, u in enumerate(units):
        m, res = r % n, u[name]
        edges = (m == 0) + (m == n - 1)
        extra = 2 * rows if fill != "none" else rows * (2 - edges)
        assert res["shape"] == (2, 8 // n + extra, 6, 8), (m, res["shape"])
        assert res["forward"] == 0.0
        assert res["double_backward"] <= TOL
        assert res["jvp"] == 0.0
    _by_kind([u[name]["backward"] for u in units], TOL)


@pytest.mark.parametrize("grid", GRIDS)
def test_gather_and_split_rows(spatial4, grid):
    for u in _rank_units(spatial4, grid):
        g = u["gather"]
        assert g["forward"] == 0.0 and g["jvp"] == 0.0
        assert g["backward"] <= TOL and g["double_backward"] <= TOL
        assert g["split_backward"] == 0.0
        assert u["forms_bitwise"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("op", ["conv3x3", "upsample2x", "downsample2x"])
def test_split_op_at_the_cuts_and_the_edges(spatial4, grid, op):
    units = _rank_units(spatial4, grid)
    _by_kind([u[op]["forward"] for u in units], TOL)
    _by_kind([u[op]["backward"] for u in units], TOL)
    if op == "conv3x3":
        assert max(u[op]["weights"] for u in units) <= TOL


@pytest.mark.parametrize("grid", GRIDS)
def test_kernel_c_route_on_haloed_tiles(spatial4, grid):
    _by_kind([u["conv3x3_c"]["forward"]
              for u in _rank_units(spatial4, grid)], TOL32)


@pytest.mark.parametrize("grid", GRIDS)
def test_generator_and_discriminator_split(spatial4, grid):
    units = _rank_units(spatial4, grid)
    _by_kind([u["generator"] for u in units], TOL)
    assert max(u["discriminator"] for u in units) <= TOL


def test_step_on_the_1x4_spatial_grid_equals_pgx(spatial4):
    outs, want = spatial4
    assert [o["grid"] for o in outs] == [(1, 4, 0, m, "spatial")
                                         for m in range(4)]
    result = (*want["reverse"], [o["reverse"] for o in outs])
    check_variant(result, "reverse", False)
