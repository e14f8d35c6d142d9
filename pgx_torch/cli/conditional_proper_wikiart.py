"""Conditional WikiArt 4->128 WGAN-GP on a CUDA device (counterpart of
``pgx/cli/conditional_proper_wikiart.py``; mirrors the reference's
conditional_proper_wikiart.py: 14 classes,
ConditionalCorrectGenerator/DiscriminatorWgangp at max_step=6,
metadata-CSV dataset filtering images by size >= current resolution).

    python -m pgx_torch.cli.conditional_proper_wikiart --csv data_info.csv \
        --image-root WIKIART/ --output runs/

``--synthetic`` (or no ``--csv``) trains on synthetic data; past
``--max-step 6`` it takes the grown plan (``zoo.conditional_correct_grown``);
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU."""

from __future__ import annotations

import argparse
import functools

import numpy as np

from pgx_torch.cli.common import add_ada_args, add_common_args, \
    add_stage_batch_arg, maybe_init_multihost, parse_stage_batches, \
    run_trainer
from pgx_torch.data import WikiArtDataset, synthetic_dataset
from pgx_torch.data.pipeline import (array_batches, normalize_to_unit,
                                     ordered_map_pool)
from pgx_torch.models import zoo
from pgx_torch.train import ProperSchedule


def wikiart_batches(dataset: WikiArtDataset, batch_size: int,
                    resolution: int, seed: int = 0, num_workers: int = 0):
    """Infinite shuffled batches over the size-filtered subset
    (conditional_proper_wikiart.py:22-47).  ``num_workers > 0`` decodes
    through ``ordered_map_pool``: the same stream as the synchronous
    path."""
    subset = dataset.subset_for(resolution)
    if not subset:
        raise ValueError(f"no WikiArt images with size >= {resolution}")
    rng = np.random.RandomState(seed)
    n = len(subset)
    load = lambda f: dataset.load(f, resolution)
    with ordered_map_pool(num_workers) as pmap:
        while True:
            order = rng.permutation(n)
            for start in range(0, n - batch_size + 1, batch_size):
                rows = [subset[int(i)]
                        for i in order[start:start + batch_size]]
                files = [f for f, _ in rows]
                imgs = np.stack(list(pmap(load, files)))
                labels = np.asarray([c for _, c in rows], np.int64)
                yield normalize_to_unit(imgs), labels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="wikiart", z_dim=512,
                                     channels=512, max_step=6, tanh=False,
                                     checkpoint_every=2000))
    p.add_argument("--csv", type=str, default=None,
                   help="data_info.csv path (filename,category,size)")
    p.add_argument("--image-root", type=str, default=None)
    p.add_argument("--num-classes", type=int, default=14)
    p.add_argument("--images-per-mini-step", type=int, default=800000)
    p.add_argument("--equal-embed", action="store_true")
    add_stage_batch_arg(p)
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    if args.max_step > 6:
        # past the reference family's 128px ceiling: the grown halving
        # plan, trainable from scratch (7 -> 256px ... 9 -> 1024px)
        gcfg, dcfg = zoo.conditional_correct_grown(
            args.max_step, z_dim=args.z_dim, channel=args.channels,
            num_classes=args.num_classes, pixel_norm=args.pixel_norm,
            tanh=args.tanh, equal_embed=args.equal_embed, dtype=args.dtype)
    else:
        gcfg = zoo.conditional_correct_generator(
            z_dim=args.z_dim, num_classes=args.num_classes,
            channel=args.channels, pixel_norm=args.pixel_norm,
            tanh=args.tanh, max_step=args.max_step,
            do_equal_embed=args.equal_embed, dtype=args.dtype)
        dcfg = zoo.conditional_correct_discriminator_wgangp(
            feat_dim=args.channels, num_classes=args.num_classes,
            do_equal_embed=args.equal_embed, max_step=args.max_step,
            dtype=args.dtype)
    schedule = ProperSchedule(args.images_per_mini_step, args.batch_size,
                              args.max_step, args.init_step,
                              stage_batches=parse_stage_batches(
                                  args.stage_batches, args.max_step,
                                  args.init_step))

    if args.synthetic or args.csv is None:
        dataset = synthetic_dataset(n=max(4 * args.batch_size, 256),
                                    size=4 * 2 ** (args.max_step - 1),
                                    channels=3, num_classes=args.num_classes,
                                    seed=args.seed)
        batch_fn = array_batches
    else:
        dataset = WikiArtDataset(args.csv, args.image_root or ".")
        if args.limit_images:
            dataset.limit(args.limit_images, seed=args.seed)
        batch_fn = functools.partial(wikiart_batches,
                                     num_workers=args.data_workers)

    return run_trainer(args, gcfg, dcfg, schedule, dataset, batch_fn=batch_fn)


if __name__ == "__main__":
    main()
