"""CIFAR-10 legacy 8->32 progressive WGAN-GP training on a CUDA device
(counterpart of ``pgx/cli/cifar_train.py``; mirrors the reference's
cifar_train.py: z=128, ch=128, bs=4, 300k iters, max_step=3).

    python -m pgx_torch.cli.cifar_train --path CIFAR/ --output runs/

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU."""

from __future__ import annotations

import argparse

from pgx_torch.cli.common import add_ada_args, add_common_args, get_dataset, \
    maybe_init_multihost, run_trainer
from pgx_torch.models import zoo
from pgx_torch.train import LegacySchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="cifar", z_dim=128,
                                     channels=128, total_iter=300000,
                                     max_step=3))
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    gcfg = zoo.legacy_generator(z_dim=args.z_dim, channel=args.channels,
                                pixel_norm=args.pixel_norm, tanh=args.tanh,
                                max_step=args.max_step, dtype=args.dtype)
    dcfg = zoo.legacy_discriminator(feat_dim=args.channels,
                                    max_step=args.max_step, dtype=args.dtype)
    schedule = LegacySchedule(args.total_iter, args.max_step, args.init_step)
    dataset = get_dataset(args, "cifar10")

    return run_trainer(args, gcfg, dcfg, schedule, dataset)


if __name__ == "__main__":
    main()
