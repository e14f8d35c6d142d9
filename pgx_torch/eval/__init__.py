"""Evaluation: InceptionV3 FID and KID, the checkpoint sweep and the
in-training FID (counterpart of ``pgx/eval``)."""

from pgx_torch.eval.fid import (  # noqa: F401
    calculate_activation_statistics,
    calculate_fid_given_data,
    calculate_frechet_distance,
    get_activations,
    make_extractor,
    preprocess,
    to_uint8_quirk,
)
from pgx_torch.eval.inception import (  # noqa: F401
    inception_from_jax_params,
    inception_pool3,
    init_inception,
    load_torch_weights,
)
from pgx_torch.eval.kid import (  # noqa: F401
    calculate_kid_given_data,
    kid_from_activations,
    mmd2_unbiased,
    polynomial_kernel,
)
from pgx_torch.eval.sweep import (  # noqa: F401
    TrainingFid,
    generate_samples,
    load_kid_scores,
    load_real_statistics,
    precompute_real_statistics,
    sweep_trial,
)
