"""Conditional 'proper' CIFAR-10 WGAN-GP training on a CUDA device
(counterpart of ``pgx/cli/conditional_proper_cifar_train.py``:
ConditionalCorrectGenerator + ConditionalCorrectDiscriminatorWgangp,
images-seen schedule).

    python -m pgx_torch.cli.conditional_proper_cifar_train --synthetic \
        --max-step 6 --output runs/

writes ``runs/trial_cond_proper_cifar_<date>_<hour>_<minute>/`` (configs,
CSV log, ``timing.json``, ``sample/*.png``, ``checkpoint/*``); ``--resume
DIR`` continues a trial; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU.

``--ada-heads`` selects the Ada model pair (normalized-embed G +
projection D) that the reference imports but never instantiates."""

from __future__ import annotations

import argparse

from pgx_torch.cli.common import add_ada_args, add_common_args, \
    add_stage_batch_arg, get_dataset, maybe_init_multihost, \
    parse_stage_batches, run_trainer
from pgx_torch.models import zoo
from pgx_torch.train import ProperSchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="cond_proper_cifar",
                                     z_dim=512, channels=512, max_step=4,
                                     tanh=False, checkpoint_every=2000))
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--images-per-mini-step", type=int, default=800000)
    p.add_argument("--equal-embed", action="store_true")
    p.add_argument("--ada-heads", action="store_true")
    add_stage_batch_arg(p)
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    if args.ada_heads:
        gcfg = zoo.conditional_correct_generator_ada(
            z_dim=args.z_dim, num_classes=args.num_classes,
            channel=args.channels, pixel_norm=args.pixel_norm,
            tanh=args.tanh, max_step=args.max_step, dtype=args.dtype)
        dcfg = zoo.conditional_correct_discriminator_ada(
            feat_dim=args.channels, num_classes=args.num_classes,
            max_step=args.max_step, dtype=args.dtype)
    elif args.max_step > 6:
        # past the reference family's 128px ceiling: the grown halving
        # plan (zoo.conditional_correct_grown), trainable from scratch —
        # 7 -> 256px, 8 -> 512px, 9 -> 1024px
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
    dataset = get_dataset(args, "cifar10", num_classes=args.num_classes)

    return run_trainer(args, gcfg, dcfg, schedule, dataset)


if __name__ == "__main__":
    main()
