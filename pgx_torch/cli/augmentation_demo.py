"""ADA augmentation visual demo on a CUDA device (counterpart of
``pgx/cli/augmentation_demo.py``; mirrors the reference's
ada/augmentation_fun.py): a grid sweeping the augmentation probability p
over [0, 1) on one batch of images, one row per p.

    python -m pgx_torch.cli.augmentation_demo --synthetic --out aug.png

Row r draws its transforms from ``torch.Generator`` seeded ``--seed + r``
(``pgx`` draws from ``jax.random.PRNGKey(seed + r)``: the rows with p > 0
differ between the packages by design, the p = 0 row does not).  At a
square size the geometric stage takes the shear warp (kernel F).
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pgx_torch.augment import TorchDraws, augment_pipe, bgc_config
from pgx_torch.data import synthetic_dataset
from pgx_torch.data.pipeline import normalize_to_unit
from pgx_torch.utils import resolve_device
from pgx_torch.utils.png import save_image_grid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", default=None, help="image folder (optional)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="augmentation_demo.png")
    p.add_argument("--rows", type=int, default=5, help="p values, 0..1")
    p.add_argument("--cols", type=int, default=5)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to augment on (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.path and not args.synthetic:
        from pgx_torch.data import ImageFolderDataset
        from pgx_torch.data.pipeline import folder_batches
        ds = ImageFolderDataset(args.path)
        imgs, _ = next(folder_batches(ds, args.cols, args.size,
                                      seed=args.seed))
    else:
        ds = synthetic_dataset(n=args.cols, size=args.size, channels=3,
                               seed=args.seed)
        imgs = normalize_to_unit(ds.at_resolution(args.size))

    cfg = bgc_config(noise=1, cutout=1, imgfilter=1 if args.size >= 64 else 0)
    images = torch.from_numpy(imgs).to(dev)
    rows = []
    for r in range(args.rows):
        draws = TorchDraws(torch.Generator(device=dev).manual_seed(
            args.seed + r))
        out = augment_pipe(draws, images, cfg, r / args.rows)
        rows.append(out.float().cpu().numpy())
    grid = np.concatenate(rows, axis=0)
    save_image_grid(args.out, grid, nrow=args.cols)
    print(f"wrote {args.out} ({args.rows} p-levels x {args.cols} images)")
    return args.out


if __name__ == "__main__":
    main()
