"""The port's WGAN-GP step on a (data, model) grid of ranks against pgx's
channel-sharded step (pgx/parallel/tp.py) on a ``make_mesh_2d`` mesh.

Two gloo ranks on the CPU (tests/torch_ddp_worker.py, case ``tp_step``,
which imports pgx_torch and never JAX or pgx) form the (1, 2) grid: each
holds its block of every sharded leaf of the state (``tp.shard_state``),
takes its rows of the global batch and runs
``make_train_step(..., mesh=)``; pgx runs the same iteration here with its
state placed by ``shard_state`` on ``make_mesh_2d(1, 2)`` of the
conftest's virtual CPU devices, the batch by ``shard_batch``, and its
unchanged step (GSPMD partitions it), as tests/test_tp.py runs it.  The
setting is tests/test_torch_ddp.py's: the tiny f64 conditional "proper"
pair (channel 8: the conv leaves shard, to_rgb's 3 channels do not), global
batch 4, one initial state carried across with ``train_state_from_jax``,
pgx's own draws at the global batch.

Variants here: the reverse and the jvp penalty and ``remat='full'`` (held
against pgx's step without remat, the same arithmetic);
tests/test_torch_tp_step_modes.py runs ``fused_g`` (no second gather of D)
and ``d_concat`` the same way.  Tolerances (tests/test_torch_ddp.py's):
metrics at rtol 1e-9, the gathered parameters and Adam's ``mu`` and ``nu``
at 1e-9 of each tensor's largest entry.  In the worker the blocks are
checked equal within each data group and the gathered state equal on every
rank, bit for bit (``check_replica_consistency(mesh=)``).  Each rank holds
the replicated leaves and half of the sharded ones.
tests/test_torch_tp_step_ada.py holds ADA at (1, 2),
tests/test_torch_tp_grid.py the (2, 2) grid.
"""

import jax
import jax.numpy as jnp
import pytest

from pgx import parallel as jpar
from pgx.augment import AdaConfig as JAdaConfig
from pgx.augment import pipe as jpipe
from pgx.train import wgan as jwgan
from tests.test_torch_ddp import (ADA, DKW, GKW, STEP, JD, JG, _batch,
                                  _draws, _initial_state, _plain,
                                  check_variant)
from tests.test_torch_parallel import run_ranks

VARIANTS = {
    "reverse": dict(tc={}, ada=False, iterations=2),
    "jvp": dict(tc=dict(gp_mode="jvp"), ada=False, iterations=1),
    "remat_full": dict(tc=dict(remat=True, remat_policy="full"),
                       pgx_tc={}, ada=False, iterations=1),
}


def run_tp_variants(variants, n_data, n_model, forms=False):
    """Every variant through pgx's sharded step on ``make_mesh_2d(n_data,
    n_model)`` and through the port's ranks on the same grid (one launch):
    ``{variant: (pgx's metrics per iteration, pgx's final state, the ranks'
    results)}``, and the ranks' ``forms`` results when asked."""
    mesh = jpar.make_mesh_2d(n_data, n_model)
    res = JG.resolution(STEP)
    inputs, want, steps = {}, {}, {}
    for name, var in variants.items():
        seed = 11 + len(inputs)
        jstate = _initial_state(seed, ada_p=0.6 if var["ada"] else 0.0)
        plain = _plain(jstate)
        kw = {}
        if var["ada"]:
            kw = dict(augment_cfg=jpipe.bgc_config(),
                      ada_cfg=JAdaConfig(**ADA))
        jstate = jpar.shard_state(mesh, jstate)
        its, jmetrics = [], []
        for i in range(var["iterations"]):
            real, labels = _batch(seed=60 + 7 * seed + i)
            z, eps, aug = _draws(jstate, var["ada"], res)
            pgx_tc = var.get("pgx_tc", var["tc"])
            key = (tuple(sorted(pgx_tc.items())), var["ada"])
            if key not in steps:
                steps[key] = jwgan.make_train_step(
                    JG, JD, jwgan.TrainConfig(**pgx_tc), step=STEP,
                    fading=False, donate=False, **kw)
            r_dev, l_dev = jpar.shard_batch(mesh, jnp.asarray(real),
                                            jnp.asarray(labels))
            jstate, m = steps[key](jstate, r_dev, l_dev,
                                   jnp.asarray(1.0, jnp.float64))
            jmetrics.append({k: float(v) for k, v in m.items()})
            its.append(dict(real=real, labels=labels, z=z, eps=eps, aug=aug,
                            apply_gp=True))
        inputs[name] = dict(tc=var["tc"], ada=ADA if var["ada"] else None,
                            step=STEP, state=plain, iterations=its)
        want[name] = (jmetrics, jax.device_get(jstate))
    outs = run_ranks("tp_step", {"gkw": GKW, "dkw": DKW, "variants": inputs,
                                 "n_model": n_model, "forms": forms},
                     world=n_data * n_model, timeout=300)
    results = {name: (*want[name], [o[name] for o in outs])
               for name in variants}
    return results, [o.get("forms") for o in outs]


def check_tp_variant(result, name, ada, n_data, n_model):
    """One variant against pgx (check_variant's tolerances), the grid
    layout, and the bytes each rank held at rest."""
    check_variant(result, name, ada)
    ranks = result[2]
    assert [r["grid"] for r in ranks] == [
        (d, m) for d in range(n_data) for m in range(n_model)]
    # at rest: the replicated leaves whole, 1/n_model of the sharded ones
    # (the tiny pair's conv and linear leaves all shard; to_rgb, the
    # controller and the counters do not)
    whole, rest = ranks[0]["bytes"]
    assert all(r["bytes"] == (whole, rest) for r in ranks)
    st = ranks[0]["state"]
    replicated = 4 * len(st["ada"])        # the controller's f32 scalars
    for net in ("g", "d", "g_ema"):
        for n, a in st[net].items():
            if a.ndim == 0 or a.shape[-1] % n_model:
                replicated += a.nbytes
    for opt, net in (("opt_g", "g"), ("opt_d", "d")):
        for mom in ("mu", "nu"):
            for n, a in st[opt][mom].items():
                if a.ndim == 0 or a.shape[-1] % n_model:
                    replicated += a.nbytes
    assert rest == replicated + (whole - replicated) // n_model, (
        whole, rest, replicated)
    assert replicated < whole // 20


@pytest.fixture(scope="module")
def tp12():
    return run_tp_variants(VARIANTS, 1, 2)[0]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_on_the_1x2_grid_equals_pgx_sharded_step(tp12, name):
    check_tp_variant(tp12[name], name, False, 1, 2)
