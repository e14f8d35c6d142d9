"""Import a reference (PyTorch) trial (counterpart of
``pgx/cli/import_checkpoint.py``).

The reference saves raw state dicts as ``{iter}_g.model`` /
``{iter}_d.model`` under ``trial_*/checkpoint/`` beside a
``train_config_*.json``.  This CLI converts such a trial (or one checkpoint
pair) into a trial directory of this package (npz checkpoints in ``pgx``'s
layout and a config JSON) for ``pgx_torch.cli.fid_sweep``, sampling or
resuming training.

    python -m pgx_torch.cli.import_checkpoint --trial /ref/trial_proper \\
        --family proper --out /tmp/imported

    python -m pgx_torch.cli.import_checkpoint --g-model 100000_g.model \\
        --family conditional_proper --num-classes 10 --out /tmp/imported

A ``schedule`` block in the source config (``export_torch_checkpoint``
writes one) is carried over, so the imported trial can be swept.
``--sample`` renders a 5x5 grid from each imported generator through the
sampling function on ``--device``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.checkpoint.torch_import import (FAMILIES, import_checkpoint_pair,
                                               infer_ref_config,
                                               load_torch_state_dict)


def _write_sample(out_dir, name, gcfg, g_params, seed=0, device="cuda"):
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import make_eval_generate
    from pgx_torch.utils.png import save_image_grid

    n = 25
    gen = Generator.from_jax_params(gcfg, g_params, device)
    z = torch.from_numpy(np.random.RandomState(seed).randn(
        n, gcfg.z_dim).astype(np.float32)).to(gen.input.w.device)
    labels = None
    if gcfg.conditioning != "none":
        labels = torch.arange(n, device=z.device) % gcfg.num_classes
    imgs = make_eval_generate(gcfg, step=gcfg.max_step)(gen, z, labels, 1.0)
    os.makedirs(os.path.join(out_dir, "sample"), exist_ok=True)
    path = os.path.join(out_dir, "sample", f"{name}_imported.png")
    save_image_grid(path, imgs.float().cpu().numpy(), nrow=5)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trial", help="reference trial dir "
                                   "(train_config_*.json + checkpoint/)")
    p.add_argument("--g-model", help="single *_g.model file instead of a "
                                     "trial dir")
    p.add_argument("--d-model", help="optional *_d.model companion")
    p.add_argument("--family", required=True, choices=sorted(FAMILIES),
                   help="reference model family (per training script)")
    p.add_argument("--num-classes", type=int, default=10,
                   help="conditional class count (the reference does not "
                        "record it in its config JSON)")
    p.add_argument("--out", required=True, help="output trial dir")
    p.add_argument("--latest-only", action="store_true",
                   help="convert only the newest checkpoint pair")
    p.add_argument("--sample", action="store_true",
                   help="render a 5x5 sample grid per imported generator")
    p.add_argument("--device", default="cuda",
                   help="torch device for --sample (default: cuda)")
    args = p.parse_args(argv)

    if not args.trial and not args.g_model:
        p.error("provide --trial or --g-model")

    ref_cfg = {}
    if args.trial:
        try:
            ref_cfg = ckpt.load_config(args.trial)
        except FileNotFoundError:
            print("warning: no train_config_*.json in the trial dir; "
                  "inferring dims from checkpoint shapes")
    if "generator" not in ref_cfg:
        g_probes = ([args.g_model] if args.g_model
                    else ckpt.list_checkpoints(args.trial, "g"))
        if not g_probes:
            raise SystemExit(f"no *_g.model checkpoints in {args.trial}")
        d_paths = [args.d_model] if args.d_model else (
            ckpt.list_checkpoints(args.trial, "d")[-1:] if args.trial else [])
        ref_cfg = {**infer_ref_config(
            load_torch_state_dict(g_probes[-1]),
            load_torch_state_dict(d_paths[0]) if d_paths else None),
            **ref_cfg}
    gcfg, dcfg = FAMILIES[args.family](ref_cfg, args.num_classes)

    if args.g_model:
        pairs = [(args.g_model, args.d_model)]
    else:
        g_paths = ckpt.list_checkpoints(args.trial, "g")
        if not g_paths:
            raise SystemExit(f"no *_g.model checkpoints in {args.trial}")
        if args.latest_only:
            g_paths = g_paths[-1:]
        d_by_iter = {ckpt.checkpoint_iteration(pth): pth
                     for pth in ckpt.list_checkpoints(args.trial, "d")}
        pairs = [(gp, d_by_iter.get(ckpt.checkpoint_iteration(gp)))
                 for gp in g_paths]

    os.makedirs(os.path.join(args.out, "checkpoint"), exist_ok=True)
    from pgx_torch.train import TrainConfig
    tc_kwargs = {}
    if "learning_rate" in ref_cfg:
        tc_kwargs["learning_rate"] = ref_cfg["learning_rate"]
    extra = {k: ref_cfg[k] for k in
             ("batch_size", "total_iter", "images_seen_per_mini_step",
              "max_step", "init_step", "trial_name", "schedule")
             if k in ref_cfg}
    extra["imported_from"] = args.trial or args.g_model
    extra["reference_family"] = args.family
    ckpt.save_config(args.out, gcfg, dcfg, TrainConfig(**tc_kwargs),
                     extra=extra, postfix="imported")

    for g_path, d_path in pairs:
        it = ckpt.checkpoint_iteration(g_path)
        g_params, d_params = import_checkpoint_pair(g_path, d_path,
                                                    gcfg, dcfg)
        ckpt.save_params(os.path.join(args.out, "checkpoint",
                                      ckpt.checkpoint_name(it, "g")),
                         g_params)
        if d_params is not None:
            ckpt.save_params(os.path.join(args.out, "checkpoint",
                                          ckpt.checkpoint_name(it, "d")),
                             d_params)
        msg = f"imported iter {it}: G" + ("" if d_params is None else "+D")
        if args.sample:
            msg += " -> " + _write_sample(args.out, str(it).zfill(3), gcfg,
                                          g_params, device=args.device)
        print(msg)
    print(f"trial written to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
