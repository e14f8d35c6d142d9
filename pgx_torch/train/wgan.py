"""Sampling from the (EMA) generator — the serving half of
``pgx/train/wgan.py``.  The training step comes in a later slice."""

from __future__ import annotations

import torch

from pgx_torch.models.config import GeneratorConfig
from pgx_torch.models.generator import generator_apply


def make_eval_generate(gcfg: GeneratorConfig, *, step: int,
                       fading: bool = False, output: str = "float"):
    """Sampling function ``generate(gen, z, labels=None, alpha=1.0)`` shared
    by the serving path, running under ``torch.inference_mode``.

    ``output='uint8'`` quantizes on the device with
    ``floor((clip(x, -1, 1) + 1) / 2 * 255 + 0.5)`` in f32, bit-matching
    ``pgx_torch.utils.png.to_uint8``, so a host fetches 4x fewer bytes."""
    if output not in ("float", "uint8"):
        raise ValueError(f"output must be 'float' or 'uint8', got {output!r}")

    @torch.inference_mode()
    def generate(gen, z, labels=None, alpha=1.0):
        lab = labels if gcfg.conditioning != "none" else None
        img = generator_apply(gen, z, lab, step=step, alpha=alpha,
                              fading=fading)
        if output == "uint8":
            x = (torch.clamp(img.float(), -1.0, 1.0) + 1.0) * 0.5
            img = torch.floor(x * 255.0 + 0.5).to(torch.uint8)
        return img
    return generate
