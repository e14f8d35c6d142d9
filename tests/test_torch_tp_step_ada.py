"""The port's channel-sharded step with ADA against pgx's sharded step on
``make_mesh_2d(1, 2)``: the reverse and the jvp penalty with the bgc policy
and the controller firing (its sign sum and count over the world), the
pipe's draws pgx's own at the global batch, each rank keeping its rows
(1e-4, as tests/test_torch_ddp_ada.py holds ADA).  The setting is
tests/test_torch_tp_step.py's.
"""

import pytest

from tests.test_torch_tp_step import check_tp_variant, run_tp_variants

VARIANTS = {
    "reverse_ada": dict(tc={}, ada=True, iterations=1),
    "jvp_ada": dict(tc=dict(gp_mode="jvp"), ada=True, iterations=1),
}


@pytest.fixture(scope="module")
def tp12_ada():
    return run_tp_variants(VARIANTS, 1, 2)[0]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ada_step_on_the_1x2_grid_equals_pgx_sharded_step(tp12_ada, name):
    check_tp_variant(tp12_ada[name], name, True, 1, 2)
