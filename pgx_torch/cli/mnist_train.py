"""MNIST 8->32 progressive WGAN-GP training on a CUDA device (counterpart
of ``pgx/cli/mnist_train.py``; mirrors the reference's mnist_train.py).

Reference workload (mnist_train.py:274-302): z=128, ch=8, bs=4, lr=1e-3,
legacy iteration-split schedule with a 100k-iteration tail at final res.

    python -m pgx_torch.cli.mnist_train --synthetic --total-iter 60 \
        --channels 8 --batch-size 8 --output runs/

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse

from pgx_torch.cli.common import add_ada_args, add_common_args, get_dataset, \
    maybe_init_multihost, run_trainer
from pgx_torch.models import zoo
from pgx_torch.train import LegacySchedule


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, defaults=dict(trial_name="mnist", z_dim=128,
                                     channels=8, total_iter=90000,
                                     max_step=3, checkpoint_every=2000))
    p.add_argument("--tail-iterations", type=int, default=0,
                   help="extra iterations at final resolution "
                        "(reference default 100000)")
    p.add_argument("--full-conv-blocks", action="store_true",
                   help="use two-conv blocks instead of MnistConvBlock")
    add_ada_args(p)
    args = p.parse_args(argv)
    maybe_init_multihost(args)

    gcfg = zoo.mnist_generator(
        z_dim=args.z_dim, channel=args.channels, pixel_norm=args.pixel_norm,
        tanh=args.tanh, use_mnist_conv_blocks=not args.full_conv_blocks,
        dtype=args.dtype)
    dcfg = zoo.mnist_discriminator(
        feat_dim=args.channels,
        use_mnist_conv_blocks=not args.full_conv_blocks, dtype=args.dtype)
    schedule = LegacySchedule(args.total_iter, args.max_step, args.init_step)
    dataset = get_dataset(args, "mnist")

    return run_trainer(args, gcfg, dcfg, schedule, dataset,
                       tail_iterations=args.tail_iterations)


if __name__ == "__main__":
    main()
