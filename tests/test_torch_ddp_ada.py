"""The port's ADA-augmented WGAN-GP step at world 2 against pgx's on a
2-device mesh: the reverse and the jvp penalty, the bgc policy with the
controller firing (its sign sum and count over the ranks), the pipe's
draws pgx's own at the global batch, each rank keeping its rows.  The
setting and the tolerances (1e-4 with ADA) are tests/test_torch_ddp.py's.
"""

import pytest

from tests.test_torch_ddp import check_variant, run_variants

VARIANTS = {
    "reverse_ada": dict(tc={}, ada=True, iterations=1),
    "jvp_ada": dict(tc=dict(gp_mode="jvp"), ada=True, iterations=1),
}


@pytest.fixture(scope="module")
def ddp_ada():
    return run_variants(VARIANTS)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ada_step_at_world_2_equals_pgx_on_the_mesh(ddp_ada, name):
    check_variant(ddp_ada[name], name, True)
