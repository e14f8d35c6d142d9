"""Generator config, factories and module of the port."""

from pgx_torch.models.config import GeneratorConfig  # noqa: F401
from pgx_torch.models.generator import (  # noqa: F401
    Generator,
    generator_apply,
    init_generator,
)
