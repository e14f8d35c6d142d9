"""Export a trained trial's (EMA) generator as a ``torch.export`` artifact
(counterpart of ``pgx/cli/export_model.py``).

The artifact is self-contained (weights inside, one program per batch
bucket) and reloads with ``pgx_torch.export.load_exported``: no model code or
checkpoints needed.  The kernels are ``torch.library`` ops in the programs,
so an artifact exported for ``cuda`` launches them on the card.  See
pgx_torch/export.py.

    python -m pgx_torch.cli.export_model --trial trial_x/ --out model.pgx/
    python -m pgx_torch.cli.export_model --trial trial_x/ --out model.pgx/ \
        --batch-sizes 1,16,64 --output float --verify
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial", required=True, help="trial directory")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="iteration index (default: latest)")
    p.add_argument("--batch-sizes", default="1,8,64",
                   help="comma-separated batch buckets to export")
    p.add_argument("--output", default="uint8", choices=["uint8", "float"],
                   help="on-device output format (uint8 = 4x smaller)")
    p.add_argument("--device", default="cuda",
                   help="where the programs run (default: cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and print a sample checksum")
    args = p.parse_args(argv)

    from pgx_torch.export import export_trial, load_exported

    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    manifest = export_trial(args.trial, args.out, checkpoint=args.checkpoint,
                            output=args.output, batch_sizes=batch_sizes,
                            device=args.device)
    print(json.dumps(manifest, indent=2, sort_keys=True))

    if args.verify:
        gen = load_exported(args.out)
        imgs = gen.sample(min(batch_sizes), seed=0,
                          class_id=0 if gen.conditional else None)
        print(f"verify: sampled {imgs.shape} {imgs.dtype}, "
              f"mean={float(np.asarray(imgs, np.float64).mean()):.4f}")


if __name__ == "__main__":
    main()
