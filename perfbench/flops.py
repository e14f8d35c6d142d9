"""Model FLOPs of the conditional Progressive GAN from a configuration's
shapes: 2 x the multiply-adds of every convolution, transposed convolution
and linear layer, in the passes the plain reference runs.  Recomputation
is not counted; elementwise work, resampling and the augmentation pipe's
matrices are not model FLOPs.

Per layer of MACs ``m`` (per image) a pass costs: the forward ``m``; the
weight gradient ``m``; the input gradient ``m``.  Every layer's input
gradient is taken: the first layers of both nets read a label embedding
(G's latent concatenates it to z, D's from_rgb reads the label plane), so
a gradient reaches their inputs.  One iteration of the WGAN-GP step
(``reference.step``):

  D step   G forward (with grad under fused_g); D forward on the reals and
           on the fakes, each with weight and input gradients;
  penalty  D forward on x_hat, its input gradient, and the backward of
           both: the input-gradient pass differentiated in its two operands
           (2 m) and the forward's weight and input gradients;
  G step   (without fused_g) G forward, D forward, D's input gradients down
           to the image (D frozen), G's weight and input gradients;
  G's weight and input gradients.
"""

from __future__ import annotations

from typing import List

PEAK_BF16_FLOPS = 989e12   # one H100 SXM, dense bf16 (NVIDIA data sheet)


def g_layers(g: dict, step: int) -> List[int]:
    """MACs per image of G's layers at ``step``, input first."""
    ch, z, e = g["channels"], g["z_dim"], g["embed_dim"]
    stage = min(step, g["max_step"]) - 1
    out = [(z + e) * 16 * ch[0], 16 * 9 * ch[0] * ch[0]]
    for k in range(1, stage + 1):
        r2 = (4 * 2 ** k) ** 2
        out += [r2 * 9 * ch[k - 1] * ch[k], r2 * 9 * ch[k] * ch[k]]
    out.append((4 * 2 ** stage) ** 2 * ch[stage] * 3)
    return out


def d_layers(d: dict, step: int) -> List[int]:
    """MACs per image of D's layers at ``step``, the image's first."""
    si, so = d["stage_in"], d["stage_out"]
    entry = min(step, d["max_step"]) - 1
    out = [(4 * 2 ** entry) ** 2 * 4 * si[entry]]
    for k in range(entry, 0, -1):
        r2 = (4 * 2 ** k) ** 2
        out += [r2 * 9 * si[k] * so[k], r2 * 9 * so[k] * so[k]]
    out += [16 * 9 * (si[0] + 1) * so[0], 16 * so[0] * so[0], so[0]]
    return out


def iteration_macs(cfg: dict, apply_gp: bool) -> int:
    """MACs per image of one iteration of the configuration's step, in
    units of each net's forward: G (g) and D (d)."""
    step, tr = cfg["step"], cfg["train"]
    g = sum(g_layers(cfg["generator"], step))
    d = sum(d_layers(cfg["discriminator"], step))
    # G forward, D on reals and fakes with both gradients, G's gradients
    macs = g + 2 * d + 2 * (2 * d) + 2 * g
    if not tr["fused_g"]:
        # G step: G forward, D forward and input gradient
        macs += g + 2 * d
    if apply_gp:
        # D on x_hat, its input gradient, that pass's two operands and the
        # forward's two gradients in the backward
        macs += d + d + 2 * d + 2 * d
    return macs


def train_flops_per_image(cfg: dict) -> float:
    """Model FLOPs per image of an iteration, averaged over the lazy
    penalty's cadence (one penalty iteration in ``gp_every``)."""
    every = cfg["train"]["gp_every"]
    macs = (iteration_macs(cfg, True)
            + (every - 1) * iteration_macs(cfg, False)) / every
    return 2.0 * macs


def generate_flops_per_image(cfg: dict) -> float:
    """Model FLOPs of one image of G's forward at the configuration's
    step."""
    return 2.0 * sum(g_layers(cfg["generator"], cfg["step"]))
