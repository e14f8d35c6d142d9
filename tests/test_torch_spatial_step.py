"""The port's WGAN-GP step on a (1, 2) spatial grid against pgx's step on
``make_mesh_2d(1, 2)`` with the images placed by pgx's
``spatial_batch_sharding`` (batch over ``data``, H over ``model``; GSPMD
partitions the step with its halo exchanges, tests/test_tp.py).

Two gloo ranks on the CPU (tests/torch_ddp_worker.py, case ``spatial``)
each hold the whole state (pgx replicates it), the rows of every image
their half of H and the global draws, and run
``make_train_step(..., mesh=make_mesh_2d(1, 2, mode='spatial'))``.  The
setting is tests/test_torch_ddp.py's: the tiny f64 conditional "proper"
pair at step 2 (8px: four rows a rank, G split from its 4x4 input, D's
head gathered at 4px), global batch 4, one initial state carried across
with ``train_state_from_jax``, pgx's own draws.

Variants: the reverse penalty over two iterations, the jvp penalty (the
row collectives' ``jvp`` in the dual forward), ``fused_g``,
``remat='full'`` (its regions re-run the halo exchanges and gathers in the
backward; held against pgx's step without remat, the same arithmetic), and
ADA with the controller firing (the pipe on whole images: gather, warp,
split).  Tolerances (``check_variant``): metrics at rtol 1e-9, parameters
and Adam's ``mu`` and ``nu`` at 1e-9 of each tensor's largest entry; ADA
1e-4.  The state is the same on both ranks, bit for bit.
tests/test_torch_spatial.py holds the (1, 4) grid and the units.
"""

import pytest

from tests.test_torch_ddp import check_variant
from tests.test_torch_spatial import run_spatial

VARIANTS = {
    "reverse": dict(tc={}, ada=False, iterations=2),
    "jvp": dict(tc=dict(gp_mode="jvp"), ada=False, iterations=1),
    "fused_g": dict(tc=dict(fused_g=True), ada=False, iterations=1),
    "remat_full": dict(tc=dict(remat=True, remat_policy="full"), pgx_tc={},
                       ada=False, iterations=1),
    "ada": dict(tc={}, ada=True, iterations=1),
}


@pytest.fixture(scope="module")
def spatial12():
    return run_spatial(2, VARIANTS, units=False)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_on_the_1x2_spatial_grid_equals_pgx(spatial12, name):
    outs, want = spatial12
    assert [o["grid"] for o in outs] == [(1, 2, 0, m, "spatial")
                                         for m in range(2)]
    check_variant((*want[name], [o[name] for o in outs]), name,
                  VARIANTS[name]["ada"])
