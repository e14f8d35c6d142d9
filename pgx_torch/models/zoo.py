"""Generator factories of ``pgx.models.zoo`` (the G halves only)."""

from __future__ import annotations

from pgx_torch.models.config import GeneratorConfig


def correct_generator(z_dim: int = 512, channel: int = 512,
                      pixel_norm: bool = True, tanh: bool = False,
                      max_step: int = 4, **kw) -> GeneratorConfig:
    """progan_modules.CorrectGenerator."""
    c = channel
    return GeneratorConfig(z_dim=z_dim, channels=(c, c, c, c),
                           pixel_norm=pixel_norm, tanh=tanh,
                           max_step=max_step, arch="proper", **kw)


def conditional_correct_generator(z_dim: int = 512, num_classes: int = 10,
                                  channel: int = 512, pixel_norm: bool = True,
                                  tanh: bool = False, max_step: int = 4,
                                  do_equal_embed: bool = False,
                                  **kw) -> GeneratorConfig:
    """progan_modules.ConditionalCorrectGenerator: 6 stages to 128x128,
    label embedding of dim z_dim concatenated to z."""
    c = channel
    return GeneratorConfig(
        z_dim=z_dim, channels=(c, c, c, c, c // 2, c // 4),
        pixel_norm=pixel_norm, tanh=tanh, max_step=max_step, arch="proper",
        conditioning="concat", num_classes=num_classes, embed_dim=z_dim,
        equal_embed=do_equal_embed, **kw)


def mnist_generator(z_dim: int = 128, channel: int = 64,
                    pixel_norm: bool = True, tanh: bool = True,
                    use_mnist_conv_blocks: bool = True,
                    **kw) -> GeneratorConfig:
    """mnist_pggan.Generator: grayscale, 8..32 px, LeakyReLU(0.1) input."""
    c = channel
    return GeneratorConfig(
        z_dim=z_dim, channels=(c, c, c, c), img_channels=1,
        pixel_norm=pixel_norm, tanh=tanh, max_step=3, arch="legacy",
        block_type="single" if use_mnist_conv_blocks else "double",
        input_lrelu_slope=0.1, **kw)


def conditional_correct_grown(max_step: int, z_dim: int = 512,
                              channel: int = 512, num_classes: int = 10,
                              pixel_norm: bool = True, tanh: bool = False,
                              **kw) -> GeneratorConfig:
    """The conditional 'proper' generator grown past 128px: constant
    ``channel`` through 32px, then halving per stage.  Resolution is
    ``4 * 2**(max_step-1)``.  (``pgx`` returns the D config beside it; the
    port has no discriminator yet.)"""
    c = channel
    plan = [c, c, c, c] + [c // 2 ** k for k in range(1, 8)]
    g_ch = tuple(plan[:max_step])
    if g_ch and g_ch[-1] < 1:
        raise ValueError(
            f"channel={channel} is too small for max_step={max_step}: the "
            f"halving plan reaches {g_ch[-1]} channels; need channel >= "
            f"{2 ** (max_step - 4)}")
    return GeneratorConfig(
        z_dim=z_dim, channels=g_ch, pixel_norm=pixel_norm, tanh=tanh,
        max_step=max_step, arch="proper", conditioning="concat",
        num_classes=num_classes, embed_dim=z_dim, **kw)
