"""Export a trial to the reference's (PyTorch) checkpoint format
(counterpart of ``pgx/cli/export_torch_checkpoint.py``).

The inverse of ``pgx_torch.cli.import_checkpoint``: a trial's npz
checkpoints become the reference's raw-state-dict ``{iter}_g.model`` /
``{iter}_d.model`` files beside a ``train_config_exported.json`` in the
reference's schema, so unmodified reference code can sample, sweep or
resume the model.

    python -m pgx_torch.cli.export_torch_checkpoint --trial runs/trial_x \\
        --out /tmp/torch_trial

The exported ``*_g.model`` is the EMA generator, as in the reference's own
checkpoints; weights are written float32 whatever the training dtype.  The
trial's ``schedule`` block rides along in the config (the reference reads
only the keys it knows), so an import of the export can be swept.
"""

from __future__ import annotations

import argparse
import json
import os

from pgx_torch import checkpoint as ckpt
from pgx_torch.checkpoint.torch_export import (export_checkpoint_pair,
                                               infer_family,
                                               reference_config_from_configs)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trial", required=True, help="trial dir")
    p.add_argument("--out", required=True,
                   help="output dir (reference trial layout)")
    p.add_argument("--latest-only", action="store_true",
                   help="convert only the newest checkpoint pair")
    p.add_argument("--no-d", action="store_true",
                   help="export generators only")
    args = p.parse_args(argv)

    cfg = ckpt.load_config(args.trial)
    gcfg, dcfg, _tc = ckpt.configs_from_dict(cfg)
    family = infer_family(gcfg, dcfg)
    ref_cfg = reference_config_from_configs(gcfg, dcfg, family)
    # the schedule fields the reference's resume arithmetic reads, and the
    # schedule block this package's sweep reads
    for k in ("batch_size", "learning_rate", "total_iter",
              "images_seen_per_mini_step", "init_step", "trial_name",
              "schedule"):
        if k in cfg:
            ref_cfg[k] = cfg[k]

    g_paths = ckpt.list_checkpoints(args.trial, "g")
    if not g_paths:
        raise SystemExit(f"no *_g.model checkpoints in {args.trial}")
    if args.latest_only:
        g_paths = g_paths[-1:]
    d_by_iter = {} if args.no_d else {
        ckpt.checkpoint_iteration(pth): pth
        for pth in ckpt.list_checkpoints(args.trial, "d")}

    out_ckpt = os.path.join(args.out, "checkpoint")
    os.makedirs(out_ckpt, exist_ok=True)
    with open(os.path.join(args.out,
                           "train_config_exported.json"), "w") as f:
        json.dump(ref_cfg, f, indent=2)

    for g_path in g_paths:
        it = ckpt.checkpoint_iteration(g_path)
        d_path = d_by_iter.get(it)
        g_params = ckpt.load_params(g_path)
        d_params = ckpt.load_params(d_path) if d_path else None
        export_checkpoint_pair(
            g_params, d_params, gcfg, dcfg,
            g_path=os.path.join(out_ckpt, ckpt.checkpoint_name(it, "g")),
            d_path=(os.path.join(out_ckpt, ckpt.checkpoint_name(it, "d"))
                    if d_params is not None else None))
        print(f"exported iter {it} ({family}): G"
              + ("" if d_params is None else "+D"))
    print(f"reference-format trial written to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
