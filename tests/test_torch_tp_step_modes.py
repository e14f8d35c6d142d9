"""The port's channel-sharded step with ``fused_g`` (one joint gradient
pass against the pre-update D: no second gather of D) and ``d_concat``
(one D forward over the concatenated batch, per-slice statistics over the
world) against pgx's sharded step on ``make_mesh_2d(1, 2)``.  The setting
and the tolerances (1e-9 in f64) are tests/test_torch_tp_step.py's.
"""

import pytest

from tests.test_torch_tp_step import check_tp_variant, run_tp_variants

VARIANTS = {
    "fused_g": dict(tc=dict(fused_g=True), ada=False, iterations=1),
    "d_concat": dict(tc=dict(d_concat=True), ada=False, iterations=1),
}


@pytest.fixture(scope="module")
def tp12_modes():
    return run_tp_variants(VARIANTS, 1, 2)[0]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_mode_on_the_1x2_grid_equals_pgx_sharded_step(tp12_modes, name):
    check_tp_variant(tp12_modes[name], name, False, 1, 2)
