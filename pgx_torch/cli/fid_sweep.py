"""Checkpoint-sweep FID (counterpart of ``pgx/cli/fid_sweep.py``).

Scores every generator checkpoint of a trial directory against real-data
statistics into an incremental ``fid_score.json`` (``--kid``: also
``kid_score.json``).  The growth schedule comes from the trial's
``train_config_*.json``.  The generator and Inception run on ``--device``
(``cuda`` unless ``cpu`` is asked for).

    python -m pgx_torch.cli.fid_sweep --trial runs/trial_x/ --dataset mnist \\
        --path /data/mnist --num-samples 2000 --inception-weights W.pth

Without ``--inception-weights`` Inception has random weights: the scores
rank checkpoints of one run, and are not on the published FID scale.
"""

from __future__ import annotations

import argparse

import numpy as np

from pgx_torch import checkpoint as ckpt
from pgx_torch.data import load_cifar10, load_mnist, load_sklearn_digits, \
    synthetic_dataset
from pgx_torch.eval import load_torch_weights, make_extractor, sweep_trial
from pgx_torch.eval.sweep import load_fid_meta
from pgx_torch.parallel import mesh as pmesh
from pgx_torch.train.schedule import schedule_from_dict
from pgx_torch.utils import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trial", required=True, help="trial directory")
    p.add_argument("--dataset", default="synthetic",
                   choices=["mnist", "cifar10", "sklearn-digits",
                            "synthetic"])
    p.add_argument("--path", default=None, help="dataset root")
    p.add_argument("--num-samples", type=int, default=2000)
    p.add_argument("--num-real", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--inception-weights", default=None,
                   help="torch state_dict file for the FID InceptionV3; "
                        "random init if absent (pipeline testing only)")
    p.add_argument("--kid", action="store_true",
                   help="also score the Kernel Inception Distance (unbiased "
                        "MMD^2 with error bars) into an incremental "
                        "kid_score.json")
    p.add_argument("--kid-subset-size", type=int, default=1000)
    p.add_argument("--kid-subsets", type=int, default=100)
    p.add_argument("--data-parallel", type=int, default=1,
                   help="split each Inception batch over this many devices "
                        "of this process")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device for the generator and Inception "
                        "(default: cuda)")
    args = p.parse_args(argv)

    cfg = ckpt.load_config(args.trial)
    if "schedule" not in cfg:
        raise SystemExit("trial config lacks a schedule block; re-run "
                         "training with this version or pass a schedule")
    schedule = schedule_from_dict(cfg["schedule"])

    if args.dataset == "mnist":
        dataset = load_mnist(args.path)
    elif args.dataset == "sklearn-digits":
        dataset = load_sklearn_digits()
    elif args.dataset == "cifar10":
        dataset = load_cifar10(args.path)
    else:
        dataset = synthetic_dataset(
            n=max(args.num_real, 256), size=32,
            channels=cfg["generator"].get("img_channels", 3),
            seed=args.seed)

    rng = np.random.RandomState(args.seed)
    images = dataset.at_resolution(dataset.images.shape[1])
    idx = rng.choice(len(images), min(args.num_real, len(images)),
                     replace=False)
    real = images[idx]

    params = (load_torch_weights(args.inception_weights)
              if args.inception_weights else None)
    if params is None:
        print("WARNING: no inception weights given — using random init; "
              "scores are NOT comparable to published FID", flush=True)
    mesh = None
    if args.data_parallel > 1:
        devs = pmesh.local_devices(resolve_device(args.device))
        if len(devs) < args.data_parallel:
            raise SystemExit(f"--data-parallel {args.data_parallel} needs "
                             f"that many devices; have {len(devs)}")
        mesh = pmesh.make_mesh(devs[:args.data_parallel])
    extractor = make_extractor(params, device=args.device, mesh=mesh)

    scores = sweep_trial(args.trial, schedule, real,
                         num_samples=args.num_samples,
                         batch_size=args.batch_size, extractor=extractor,
                         kid=args.kid, kid_subset_size=args.kid_subset_size,
                         kid_subsets=args.kid_subsets, device=args.device)
    # entries still marked in-training (per-stage baseline, no checkpoint
    # file to score again) are kept apart from the comparable set and from
    # best-of
    meta = load_fid_meta(args.trial)
    comparable = {k: v for k, v in scores.items() if k not in meta}
    leftover = {k: v for k, v in scores.items() if k in meta}
    best = (min(comparable.items(), key=lambda kv: kv[1])
            if comparable else None)
    if best:
        print(f"best: {best[0]} FID={best[1]:.2f}")
    for k in sorted(leftover):
        print(f"note: {k} keeps its in-training per-stage baseline "
              f"(no checkpoint file to re-score from); excluded from best")
    return {"comparable": comparable, "in_training": leftover}


if __name__ == "__main__":
    main()
