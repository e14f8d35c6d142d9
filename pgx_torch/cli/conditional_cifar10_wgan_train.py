"""Conditional CIFAR-10 legacy 8->32 WGAN-GP on a CUDA device (counterpart
of ``pgx/cli/conditional_cifar10_wgan_train.py``; mirrors the reference's
conditional_cifar10_wgan_train.py: ConditionalGenerator +
ConditionalDiscriminatorWgangp with spatial label planes).

    python -m pgx_torch.cli.conditional_cifar10_wgan_train --path CIFAR/ \
        --output runs/

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU."""

from __future__ import annotations

import argparse

from pgx_torch.cli.common import add_ada_args, add_common_args, get_dataset, \
    maybe_init_multihost, run_trainer
from pgx_torch.models import zoo
from pgx_torch.train import LegacySchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="cond_cifar", z_dim=128,
                                     channels=128, total_iter=300000,
                                     max_step=3))
    p.add_argument("--num-classes", type=int, default=10)
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    gcfg = zoo.conditional_generator(
        z_dim=args.z_dim, num_classes=args.num_classes,
        channel=args.channels, pixel_norm=args.pixel_norm, tanh=args.tanh,
        max_step=args.max_step, dtype=args.dtype)
    dcfg = zoo.conditional_discriminator_wgangp(
        feat_dim=args.channels, num_classes=args.num_classes,
        max_step=args.max_step, dtype=args.dtype)
    schedule = LegacySchedule(args.total_iter, args.max_step, args.init_step)
    dataset = get_dataset(args, "cifar10", num_classes=args.num_classes)

    return run_trainer(args, gcfg, dcfg, schedule, dataset)


if __name__ == "__main__":
    main()
