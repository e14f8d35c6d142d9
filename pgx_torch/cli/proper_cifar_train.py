"""CIFAR-10 'proper' (paper-faithful) 4->32 progressive WGAN-GP training on
a CUDA device (counterpart of ``pgx/cli/proper_cifar_train.py``; mirrors
the reference's proper_cifar_train.py: z=512, ch=512, bs=4, 800k images
per mini-step, max_step=4, images-seen schedule).

    python -m pgx_torch.cli.proper_cifar_train --path CIFAR/ --output runs/

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU."""

from __future__ import annotations

import argparse

from pgx_torch.cli.common import add_ada_args, add_common_args, \
    add_stage_batch_arg, get_dataset, maybe_init_multihost, \
    parse_stage_batches, run_trainer
from pgx_torch.models import zoo
from pgx_torch.train import ProperSchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="proper_cifar", z_dim=512,
                                     channels=512, max_step=4, tanh=False,
                                     checkpoint_every=2000))
    p.add_argument("--images-per-mini-step", type=int, default=800000)
    add_stage_batch_arg(p)
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    gcfg = zoo.correct_generator(z_dim=args.z_dim, channel=args.channels,
                                 pixel_norm=args.pixel_norm, tanh=args.tanh,
                                 max_step=args.max_step, dtype=args.dtype)
    dcfg = zoo.correct_discriminator(feat_dim=args.channels,
                                     max_step=args.max_step,
                                     dtype=args.dtype)
    schedule = ProperSchedule(args.images_per_mini_step, args.batch_size,
                              args.max_step, args.init_step,
                              stage_batches=parse_stage_batches(
                                  args.stage_batches, args.max_step,
                                  args.init_step))
    dataset = get_dataset(args, "cifar10")

    return run_trainer(args, gcfg, dcfg, schedule, dataset)


if __name__ == "__main__":
    main()
