"""Factories of ``pgx.models.zoo``: every generator and discriminator
config of the reference zoo, and the grown high-resolution pair."""

from __future__ import annotations

from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig


# --------------------------------------------------------------------------
# legacy family (8x8 .. 256x256, no 4x4 head)
# --------------------------------------------------------------------------

def legacy_generator(z_dim: int = 128, channel: int = 128,
                     pixel_norm: bool = True, tanh: bool = True,
                     max_step: int = 6, **kw) -> GeneratorConfig:
    """progan_modules.Generator."""
    c = channel
    return GeneratorConfig(
        z_dim=z_dim, channels=(c, c, c, c, c // 2, c // 4, c // 4),
        pixel_norm=pixel_norm, tanh=tanh, max_step=max_step, arch="legacy",
        **kw)


def legacy_discriminator(feat_dim: int = 128, max_step: int = 6,
                         **kw) -> DiscriminatorConfig:
    """progan_modules.Discriminator."""
    f = feat_dim
    return DiscriminatorConfig(
        stage_in=(f, f, f, f, f // 2, f // 4, f // 4),
        stage_out=(f, f, f, f, f, f // 2, f // 4),
        arch="legacy", max_step=max_step, **kw)


def conditional_generator(z_dim: int = 128, num_classes: int = 10,
                          channel: int = 128, pixel_norm: bool = True,
                          tanh: bool = True, max_step: int = 6,
                          **kw) -> GeneratorConfig:
    """progan_modules.ConditionalGenerator: label embed of dim ==
    num_classes concatenated to z."""
    return legacy_generator(z_dim, channel, pixel_norm, tanh, max_step,
                            conditioning="concat", num_classes=num_classes,
                            embed_dim=num_classes, **kw)


def conditional_discriminator_wgangp(feat_dim: int = 128,
                                     num_classes: int = 10,
                                     **kw) -> DiscriminatorConfig:
    """progan_modules.ConditionalDiscriminatorWgangp: per-resolution
    spatial label planes."""
    return legacy_discriminator(feat_dim, conditioning="label_plane",
                                num_classes=num_classes, **kw)


# --------------------------------------------------------------------------
# "proper" (paper-faithful) family with a 4x4 head
# --------------------------------------------------------------------------


def correct_generator(z_dim: int = 512, channel: int = 512,
                      pixel_norm: bool = True, tanh: bool = False,
                      max_step: int = 4, **kw) -> GeneratorConfig:
    """progan_modules.CorrectGenerator."""
    c = channel
    return GeneratorConfig(z_dim=z_dim, channels=(c, c, c, c),
                           pixel_norm=pixel_norm, tanh=tanh,
                           max_step=max_step, arch="proper", **kw)


def correct_discriminator(feat_dim: int = 512, max_step: int = 4,
                          **kw) -> DiscriminatorConfig:
    """progan_modules.CorrectDiscriminator."""
    f = feat_dim
    return DiscriminatorConfig(stage_in=(f, f, f, f), stage_out=(f, f, f, f),
                               arch="proper", max_step=max_step, **kw)


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


def conditional_correct_discriminator_wgangp(
        feat_dim: int = 128, num_classes: int = 10,
        do_equal_embed: bool = False, max_step: int = 6,
        **kw) -> DiscriminatorConfig:
    """progan_modules.ConditionalCorrectDiscriminatorWgangp."""
    f = feat_dim
    return DiscriminatorConfig(
        stage_in=(f, f, f, f, f // 2, f // 4),
        stage_out=(f, f, f, f, f, f // 2),
        arch="proper", conditioning="label_plane", num_classes=num_classes,
        equal_embed=do_equal_embed, max_step=max_step, **kw)


def conditional_correct_generator_ada(z_dim: int = 512, num_classes: int = 10,
                                      channel: int = 512,
                                      pixel_norm: bool = True,
                                      tanh: bool = False, max_step: int = 4,
                                      **kw) -> GeneratorConfig:
    """progan_modules.ConditionalCorrectGeneratorAda: L2-normalized z and
    embed before concat."""
    c = channel
    return GeneratorConfig(
        z_dim=z_dim, channels=(c, c, c, c), pixel_norm=pixel_norm, tanh=tanh,
        max_step=max_step, arch="proper", conditioning="norm_concat",
        num_classes=num_classes, embed_dim=z_dim, **kw)


def conditional_correct_discriminator_ada(feat_dim: int = 512,
                                          num_classes: int = 10,
                                          max_step: int = 4,
                                          **kw) -> DiscriminatorConfig:
    """progan_modules.ConditionalCorrectDiscriminatorAda: projection
    head."""
    f = feat_dim
    return DiscriminatorConfig(
        stage_in=(f, f, f, f), stage_out=(f, f, f, f), arch="proper",
        conditioning="projection", num_classes=num_classes,
        max_step=max_step, **kw)


# --------------------------------------------------------------------------
# grayscale family (8x8 .. 32x32, LeakyReLU(0.1) input)
# --------------------------------------------------------------------------

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


def mnist_discriminator(feat_dim: int = 64,
                        use_mnist_conv_blocks: bool = True,
                        **kw) -> DiscriminatorConfig:
    """mnist_pggan.Discriminator."""
    f = feat_dim
    return DiscriminatorConfig(
        stage_in=(f, f, f, f), stage_out=(f, f, f, f), img_channels=1,
        arch="legacy",
        block_type="single" if use_mnist_conv_blocks else "double",
        max_step=3, **kw)


def mnist_conditional_generator(z_dim: int = 128, num_classes: int = 10,
                                channel: int = 64, pixel_norm: bool = True,
                                tanh: bool = True,
                                use_mnist_conv_blocks: bool = True,
                                **kw) -> GeneratorConfig:
    """mnist_pggan.ConditionalGenerator: normalized embed concat (dim ==
    z_dim)."""
    c = channel
    return GeneratorConfig(
        z_dim=z_dim, channels=(c, c, c, c), img_channels=1,
        pixel_norm=pixel_norm, tanh=tanh, max_step=3, arch="legacy",
        block_type="single" if use_mnist_conv_blocks else "double",
        input_lrelu_slope=0.1, conditioning="norm_concat",
        num_classes=num_classes, embed_dim=z_dim, **kw)


def mnist_conditional_discriminator_wgangp(
        feat_dim: int = 64, num_classes: int = 10,
        use_mnist_conv_blocks: bool = True, **kw) -> DiscriminatorConfig:
    """mnist_pggan.ConditionalDiscriminatorWgangp."""
    return mnist_discriminator(feat_dim, use_mnist_conv_blocks,
                               conditioning="label_plane",
                               num_classes=num_classes, **kw)


def mnist_conditional_discriminator_ada(
        feat_dim: int = 64, num_classes: int = 10,
        use_mnist_conv_blocks: bool = True, **kw) -> DiscriminatorConfig:
    """mnist_pggan.ConditionalDiscriminatorAda."""
    return mnist_discriminator(feat_dim, use_mnist_conv_blocks,
                               conditioning="projection",
                               num_classes=num_classes, **kw)


# --------------------------------------------------------------------------
# grown high-resolution configs (past the reference zoo)
# --------------------------------------------------------------------------

def conditional_correct_grown(max_step: int, z_dim: int = 512,
                              channel: int = 512, num_classes: int = 10,
                              pixel_norm: bool = True, tanh: bool = False,
                              **kw):
    """The conditional 'proper' family grown past 128px: constant
    ``channel`` through 32px, then halving per stage.  Returns
    ``(GeneratorConfig, DiscriminatorConfig)``; resolution is
    ``4 * 2**(max_step-1)``."""
    c = channel
    plan = [c, c, c, c] + [c // 2 ** k for k in range(1, 8)]
    g_ch = tuple(plan[:max_step])
    if g_ch and g_ch[-1] < 1:
        raise ValueError(
            f"channel={channel} is too small for max_step={max_step}: the "
            f"halving plan reaches {g_ch[-1]} channels; need channel >= "
            f"{2 ** (max_step - 4)}")
    d_out = (g_ch[0],) + g_ch[:-1]
    gcfg = GeneratorConfig(
        z_dim=z_dim, channels=g_ch, pixel_norm=pixel_norm, tanh=tanh,
        max_step=max_step, arch="proper", conditioning="concat",
        num_classes=num_classes, embed_dim=z_dim, **kw)
    dcfg = DiscriminatorConfig(
        stage_in=g_ch, stage_out=d_out, arch="proper",
        conditioning="label_plane", num_classes=num_classes,
        max_step=max_step, **kw)
    return gcfg, dcfg
