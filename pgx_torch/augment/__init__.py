"""ADA augmentation pipeline + adaptive-p controller of the port."""

from pgx_torch.augment.adaptive import (  # noqa: F401
    AdaConfig,
    ada_update,
    init_ada_state,
)
from pgx_torch.augment.pipe import (  # noqa: F401
    AugmentConfig,
    TorchDraws,
    augment_pipe,
    bgc_config,
)
