"""Sample from a trained trial's generator checkpoint on a CUDA device
(counterpart of ``pgx/cli/generate.py``).

Loads any ``{iter}_g.model`` checkpoint (the EMA generator), re-derives the
growth state (step, alpha) from the trial's schedule as the FID scripts do
(fid/load_cifar_model_and_fid_it.py:97-103), and writes a PNG grid and/or
an .npz of raw samples.  z comes from ``numpy.random.RandomState(seed)`` as
in ``pgx``, so both packages sample the same z.

    python -m pgx_torch.cli.generate --trial trial_xxx/ --num 100 \
        --out grid.png
    python -m pgx_torch.cli.generate --trial trial_xxx/ --checkpoint 28000 \
        --per-class 10 --npz samples.npz

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.models.generator import Generator
from pgx_torch.train.schedule import schedule_from_dict
from pgx_torch.train.wgan import make_eval_generate
from pgx_torch.utils import resolve_device
from pgx_torch.utils.png import save_image_grid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial", required=True, help="trial directory")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="iteration index (default: latest)")
    p.add_argument("--num", type=int, default=50,
                   help="sample count for unconditional models")
    p.add_argument("--per-class", type=int, default=10,
                   help="samples per class for conditional models "
                        "(one class per grid row)")
    p.add_argument("--out", default=None,
                   help="output PNG grid (default: <trial>/generated_"
                        "<iter>.png)")
    p.add_argument("--npz", default=None,
                   help="also save raw samples (+labels) as .npz")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ckpt.load_config(args.trial)
    gcfg = ckpt.generator_config_from_dict(cfg)
    schedule = schedule_from_dict(cfg["schedule"])

    try:
        gpath, params, iteration, st = ckpt.load_generator_state(
            args.trial, schedule, args.checkpoint)
    except FileNotFoundError as exc:
        raise SystemExit(str(exc))

    conditional = gcfg.conditioning != "none"
    rng = np.random.RandomState(args.seed)
    if conditional:
        c = gcfg.num_classes
        labels = np.repeat(np.arange(c), args.per_class)
        nrow = args.per_class
    else:
        labels = None
        nrow = 10
    n = len(labels) if conditional else args.num
    z = rng.randn(n, gcfg.z_dim).astype(np.float32)

    gen = make_eval_generate(gcfg, step=st.step, fading=st.fading)
    module = Generator.from_jax_params(gcfg, params, dev)
    outs = []
    for lo in range(0, n, args.batch_size):
        hi = min(lo + args.batch_size, n)
        lab = (torch.from_numpy(labels[lo:hi]).to(dev) if conditional
               else None)
        img = gen(module, torch.from_numpy(z[lo:hi]).to(dev), lab,
                  st.alpha)
        outs.append(img.float().cpu().numpy())
    images = np.concatenate(outs)

    out = args.out or os.path.join(args.trial, f"generated_{iteration}.png")
    save_image_grid(out, images, nrow=nrow)
    print(f"wrote {out} ({n} samples at {st.resolution}px, "
          f"step {st.step}, alpha {st.alpha:.2f})")
    if args.npz:
        payload = {"images": images, "z": z}
        if labels is not None:
            payload["labels"] = labels
        np.savez(args.npz, **payload)
        print(f"wrote {args.npz}")
    return out


if __name__ == "__main__":
    main()
