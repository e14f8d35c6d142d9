"""CelebA-style legacy progressive WGAN-GP training on a CUDA device
(counterpart of ``pgx/cli/train.py``; mirrors the reference's train.py).

Reference CLI (train.py:207-232): ImageFolder data with
Resize(1.2x) + RandomCrop + HFlip, legacy Generator/Discriminator,
iteration-split schedule clamped at max_step.

    python -m pgx_torch.cli.train --path IMAGES/ --output runs/

``--synthetic`` (or no ``--path``) trains on synthetic 64px data;
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import functools

from pgx_torch.cli.common import add_ada_args, add_common_args, \
    maybe_init_multihost, run_trainer
from pgx_torch.data import ImageFolderDataset, synthetic_dataset
from pgx_torch.data.pipeline import array_batches, folder_batches
from pgx_torch.models import zoo
from pgx_torch.train import LegacySchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="celeba", z_dim=128,
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

    if args.synthetic or args.path is None:
        dataset = synthetic_dataset(n=max(4 * args.batch_size, 256), size=64,
                                    channels=3, seed=args.seed)
        batch_fn = array_batches
    else:
        dataset = ImageFolderDataset(args.path, resize_factor=1.2,
                                     random_crop=True, hflip=True,
                                     seed=args.seed)
        if args.limit_images:
            dataset.limit(args.limit_images, seed=args.seed)
        batch_fn = functools.partial(folder_batches,
                                     num_workers=args.data_workers)

    return run_trainer(args, gcfg, dcfg, schedule, dataset, batch_fn=batch_fn)


if __name__ == "__main__":
    main()
