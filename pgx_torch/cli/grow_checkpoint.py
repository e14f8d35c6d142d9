"""Grow a trained smaller-net checkpoint into a bigger-max_step net on a
CUDA device (counterpart of ``pgx/cli/grow_checkpoint.py``; mirrors the
reference's scripts/smaller_to_bigger_net_checkpoint_load.py).

Loads the latest G/D checkpoints of a trial, builds larger configs (more
stages / higher max_step), copies every matching resolution-keyed parameter,
verifies on ``--device`` that the grown G draws the small G's images and the
grown D gives the small D's scores at the shared step, and writes the grown
checkpoints into a new trial directory.

The new leaves come from the port's initialisers (``init_generator`` /
``init_discriminator``, drawn from ``numpy.random.RandomState(--seed)`` and
``--seed + 1``), so they differ from ``pgx``'s JAX draws; the copied leaves
are the small trial's.  The equivalence check's z comes from
``RandomState(--seed + 1)``.

    python -m pgx_torch.cli.grow_checkpoint --trial trial_xxx/ \
        --target-channels 512,512,512,512,256,128,64,32 --target-max-step 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.models import Generator, init_discriminator, init_generator
from pgx_torch.utils import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial", required=True)
    p.add_argument("--out", default=None,
                   help="output trial dir (default: <trial>_grown)")
    p.add_argument("--target-channels", required=True,
                   help="comma-separated per-stage channels for the grown G")
    p.add_argument("--target-max-step", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-step", type=int, default=1,
                   help="shared step for the equivalence assert")
    p.add_argument("--device", default="cuda",
                   help="torch device of the equivalence check (default: "
                        "cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ckpt.load_config(args.trial)
    gcfg, dcfg, tc = ckpt.configs_from_dict(cfg)

    channels = tuple(int(c) for c in args.target_channels.split(","))
    big_g = dataclasses.replace(gcfg, channels=channels,
                                max_step=args.target_max_step)
    # D stages mirror G: stage_out[k] feeds stage_in[k-1]
    big_d = dataclasses.replace(
        dcfg,
        stage_in=channels,
        stage_out=(channels[0],) + channels[:-1],
        max_step=args.target_max_step)

    gpath = ckpt.latest_checkpoint(args.trial, "g")
    dpath = ckpt.latest_checkpoint(args.trial, "d")
    if gpath is None:
        raise SystemExit(f"no checkpoints in {args.trial}")
    small_gp = ckpt.load_params(gpath)
    small_dp = ckpt.load_params(dpath)

    big_gp = ckpt.grow_params(small_gp, init_generator(big_g, args.seed))
    big_dp = ckpt.grow_params(small_dp,
                              init_discriminator(big_d, args.seed + 1))

    # equivalence at the shared step (reference :79-92): same z/label must
    # produce the same image through G AND the same score through D
    z = np.random.RandomState(args.seed + 1).randn(
        4, gcfg.z_dim).astype(np.float32)
    labels = (np.zeros((4,), np.int64)
              if gcfg.conditioning != "none" else None)
    ckpt.assert_grow_equivalence(small_gp, gcfg, big_gp, big_g, z,
                                 labels=labels, step=args.check_step,
                                 device=dev)
    gen = Generator.from_jax_params(gcfg, small_gp, dev)
    with torch.no_grad():
        img = gen(torch.from_numpy(z).to(dev),
                  None if labels is None else torch.from_numpy(labels).to(dev),
                  step=args.check_step).float().cpu().numpy()
    del gen
    dlabels = labels if dcfg.conditioning != "none" else None
    # (a bf16 image is exact in f32; D casts it back to its dtype)
    ckpt.assert_grow_equivalence_d(small_dp, dcfg, big_dp, big_d, img,
                                   labels=dlabels, step=args.check_step,
                                   device=dev)

    out_dir = args.out or args.trial.rstrip("/") + "_grown"
    os.makedirs(os.path.join(out_dir, "checkpoint"), exist_ok=True)
    it = ckpt.checkpoint_iteration(gpath)
    ckpt.save_params(os.path.join(out_dir, "checkpoint",
                                  ckpt.checkpoint_name(it, "g")), big_gp)
    ckpt.save_params(os.path.join(out_dir, "checkpoint",
                                  ckpt.checkpoint_name(it, "d")), big_dp)
    extra = {k: v for k, v in cfg.items()
             if k not in ("generator", "discriminator", "train")}
    if "schedule" in extra and "max_step" in extra["schedule"]:
        # the copied schedule must allow the grown net's new stages:
        # tools that re-derive (step, alpha) per iteration (generate,
        # fid_sweep, create_gif) read it from this config
        extra["schedule"] = {**extra["schedule"],
                             "max_step": args.target_max_step}
    ckpt.save_config(out_dir, big_g, big_d, tc, extra=extra, postfix="grown")
    print(f"grown checkpoints written to {out_dir} "
          f"(equivalence verified at step {args.check_step})")
    return out_dir


if __name__ == "__main__":
    main()
