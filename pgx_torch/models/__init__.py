"""Model configs, factories and modules of the port."""

from pgx_torch.models.config import (  # noqa: F401
    DiscriminatorConfig,
    GeneratorConfig,
)
from pgx_torch.models.discriminator import (  # noqa: F401
    Discriminator,
    discriminator_apply,
    init_discriminator,
)
from pgx_torch.models.generator import (  # noqa: F401
    Generator,
    generator_apply,
    init_generator,
)
