"""Build the training-evolution GIF for a trial directory (counterpart of
``pgx/cli/create_gif.py``; mirrors the reference's
create_gif_proper_progan.py).  Host-only: numpy and PIL.

    python -m pgx_torch.cli.create_gif --trial trial_xxx/ [--rows 5 --cols 10]
"""

from __future__ import annotations

import argparse

from pgx_torch import checkpoint as ckpt
from pgx_torch.train.schedule import schedule_from_dict
from pgx_torch.utils.gif import build_training_gif


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--rows", type=int, default=5)
    p.add_argument("--cols", type=int, default=10)
    p.add_argument("--cell-size", type=int, default=100)
    p.add_argument("--frame-ms", type=int, default=200)
    p.add_argument("--max-frames", type=int, default=None)
    args = p.parse_args(argv)

    cfg = ckpt.load_config(args.trial)
    schedule = schedule_from_dict(cfg["schedule"])
    out = build_training_gif(args.trial, schedule, out_path=args.out,
                             rows=args.rows, cols=args.cols,
                             cell_size=args.cell_size,
                             frame_ms=args.frame_ms,
                             max_frames=args.max_frames)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
