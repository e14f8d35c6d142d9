"""The port's channel-sharded step on the (2, 2) grid: four gloo ranks
against pgx's ``make_mesh_2d(2, 2)``, the reverse penalty with ADA (the
bgc policy, the controller firing; 1e-4 as tests/test_torch_ddp_ada.py
holds ADA), the blocks equal within each data group and the gathered state
on every rank.  Then the two forms of the step's collectives, called
explicitly on the same tensors (``collectives._gather_gloo`` /
``_gather_nccl`` and ``_reduce_gloo`` / ``_reduce_nccl``, both forms
runnable on gloo's CPU tensors): the gathers bit for bit, the reductions
within f64 rounding (the sums run in another order: over the model group,
then the data group) and equal to numpy's mean over the ranks' gradients
cut to each rank's block.  The setting is tests/test_torch_tp_step.py's.
"""

import numpy as np
import pytest

from tests.test_torch_tp_step import check_tp_variant, run_tp_variants

VARIANTS = {"reverse_ada_2x2": dict(tc={}, ada=True, iterations=1)}


@pytest.fixture(scope="module")
def tp22():
    return run_tp_variants(VARIANTS, 2, 2, forms=True)


def test_step_on_the_2x2_grid_equals_pgx_sharded_step(tp22):
    results, _ = tp22
    check_tp_variant(results["reverse_ada_2x2"], "reverse_ada_2x2", True,
                     2, 2)


def test_gather_and_reduction_forms_agree_on_the_2x2_grid(tp22):
    _, forms = tp22
    n_model, world = 2, 4
    for r, f in enumerate(forms):
        assert f["gather_bitwise"] and f["gather_blocks_bitwise"], r
        assert f["reduce_max_rel"] <= 1e-15, (r, f["reduce_max_rel"])
    # each rank's reduction: the mean over the four ranks' gradients, the
    # sharded ones cut to the rank's block m = r % n_model
    for r, f in enumerate(forms):
        m = r % n_model
        for i, got in enumerate(f["reduced"]):
            mean = np.mean([forms[q]["grads"][i] for q in range(world)],
                           axis=0)
            if got.shape != mean.shape:
                k = got.shape[-1]
                assert mean.shape[-1] == n_model * k
                mean = mean[..., m * k:(m + 1) * k]
            np.testing.assert_allclose(got, mean, rtol=1e-13, atol=1e-15)
