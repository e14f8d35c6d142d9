"""Generator and discriminator configurations, field for field those of
``pgx.models.config``.

Stage numbering: stage ``k`` lives at resolution ``4 * 2**k``; stage 0 is
the 4x4 block.  The ``legacy`` arch outputs stage ``step`` at ``step``; the
``proper`` arch outputs stage ``step - 1`` and has a to_rgb at 4x4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Unified generator config.

    channels[k] is the output channel count of stage k (stage 0 = 4x4).
    """

    z_dim: int = 128
    channels: Tuple[int, ...] = (128,) * 7
    img_channels: int = 3
    pixel_norm: bool = True
    tanh: bool = True
    max_step: int = 6
    arch: str = "legacy"              # 'legacy' | 'proper'
    block_type: str = "double"        # 'double' | 'single' (mnist blocks)
    input_lrelu_slope: float = 0.2    # mnist input layer uses 0.1
    conditioning: str = "none"        # 'none' | 'concat' | 'norm_concat'
    num_classes: int = 0
    embed_dim: int = 0                # 0 -> z_dim
    equal_embed: bool = False
    dtype: str = "float32"
    # stages whose low-res input is at least this size run the upsample and
    # their first conv as one step (equal_conv2d_up2x); 0 disables
    fuse_up_conv_min_size: int = 32

    def __post_init__(self):
        assert self.arch in ("legacy", "proper")
        assert self.block_type in ("double", "single")
        assert self.conditioning in ("none", "concat", "norm_concat")
        if self.conditioning != "none":
            assert self.num_classes > 0
        need = self.max_step + 1 if self.arch == "legacy" else self.max_step
        assert len(self.channels) >= need, (
            f"max_step={self.max_step} ({self.arch}) needs >= {need} "
            f"stages, channels has {len(self.channels)} — use "
            f"zoo.conditional_correct_grown for resolutions past a "
            f"family's ceiling")

    @property
    def num_stages(self) -> int:
        return len(self.channels)

    @property
    def compute_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def embedding_dim(self) -> int:
        if self.conditioning == "none":
            return 0
        return self.embed_dim if self.embed_dim else self.z_dim

    def out_stage(self, step: int) -> int:
        """Stage index producing the image at a given step."""
        step = min(step, self.max_step)
        return step if self.arch == "legacy" else step - 1

    def resolution(self, step: int) -> int:
        return 4 * 2 ** self.out_stage(step)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Unified discriminator config.

    stage_in[k] / stage_out[k] are the conv-block channel counts of stage k
    (stage 0 = the final 4x4 block; its true input is stage_in[0] + 1 for
    the minibatch-stddev channel, added internally).
    """

    stage_in: Tuple[int, ...] = (128,) * 7
    stage_out: Tuple[int, ...] = (128,) * 7
    img_channels: int = 3
    arch: str = "legacy"              # entry stage: step / step-1 (proper)
    block_type: str = "double"        # stages > 0; stage 0 is always double
    conditioning: str = "none"        # 'none' | 'label_plane' | 'projection'
    num_classes: int = 0
    equal_embed: bool = False         # equalized label planes
    max_step: int = 6
    dtype: str = "float32"

    def __post_init__(self):
        def check(cond, msg):
            if not cond:
                raise ValueError(f"DiscriminatorConfig: {msg}")

        check(len(self.stage_in) == len(self.stage_out),
              "stage_in and stage_out differ in length")
        check(self.arch in ("legacy", "proper"), f"arch {self.arch!r}")
        check(self.block_type in ("double", "single"),
              f"block_type {self.block_type!r}")
        check(self.conditioning in ("none", "label_plane", "projection"),
              f"conditioning {self.conditioning!r}")
        if self.conditioning != "none":
            check(self.num_classes > 0, "conditioning needs num_classes > 0")
        need = self.max_step + 1 if self.arch == "legacy" else self.max_step
        check(len(self.stage_in) >= need,
              f"max_step={self.max_step} ({self.arch}) needs >= {need} "
              f"stages, stage_in has {len(self.stage_in)}")
        for k in range(1, len(self.stage_in)):
            check(self.stage_out[k] == self.stage_in[k - 1],
                  f"stage {k} out={self.stage_out[k]} must feed "
                  f"stage {k-1} in={self.stage_in[k-1]}")

    @property
    def num_stages(self) -> int:
        return len(self.stage_in)

    @property
    def feat_dim(self) -> int:
        return self.stage_out[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    def entry_stage(self, step: int) -> int:
        step = min(step, self.max_step)
        return step if self.arch == "legacy" else step - 1
