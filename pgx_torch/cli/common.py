"""Shared CLI plumbing for the training entry points (counterpart of
``pgx/cli/common.py``).

The flags are ``pgx``'s, plus ``--device`` (``cuda`` unless the caller asks
for ``cpu``); ``--compile-cache`` has no counterpart.
``--checkpoint-backend orbax`` selects the port's step-indexed store.
``--spans PATH`` records the run's spans (``pgx_torch.utils.trace``) and
writes them to PATH at exit.
``--multihost`` runs one process per rank (``maybe_init_multihost``);
with it ``--model-parallel N`` lays the ranks out as a (world / N, N) grid
and shards the train state over its model axis (``pgx_torch.parallel.tp``),
or with ``--model-parallel-mode spatial`` splits every image over H across
it, the state whole on every rank.
"""

from __future__ import annotations

import argparse

from pgx_torch.data import load_cifar10, load_mnist, load_sklearn_digits, \
    synthetic_dataset
from pgx_torch.train.loop import train_loop
from pgx_torch.utils import trace


def _steps_per_call(value: str) -> int:
    """'auto' -> 0 (the loop measures each stage and picks the window),
    otherwise a positive iteration count."""
    if value == "auto":
        return 0
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(
            "--steps-per-call takes a positive integer or 'auto'")
    return n


def add_common_args(p: argparse.ArgumentParser,
                    defaults: dict) -> argparse.ArgumentParser:
    p.add_argument("--path", type=str, default=None,
                   help="dataset root (local files; no download)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic dataset (no local data needed)")
    p.add_argument("--limit-images", type=int, default=None,
                   help="train on a class-balanced subset of N images "
                        "(limited-data regimes: the setting ADA exists for)")
    p.add_argument("--data-workers", type=int, default=0,
                   help="decode threads for file-backed datasets (0 = "
                        "synchronous; the augmentation stream is identical "
                        "either way)")
    p.add_argument("--trial-name", type=str,
                   default=defaults.get("trial_name", "trial"))
    p.add_argument("--output", "--main-path", dest="main_path", type=str,
                   default=".")
    p.add_argument("--resume", type=str, default=None,
                   help="trial dir to resume from")
    p.add_argument("--lr", type=float, default=defaults.get("lr", 1e-3))
    p.add_argument("--z-dim", type=int, default=defaults.get("z_dim", 128))
    p.add_argument("--channels", "--channel", dest="channels", type=int,
                   default=defaults.get("channels", 128))
    p.add_argument("--batch-size", type=int,
                   default=defaults.get("batch_size", 4))
    p.add_argument("--n-critic", type=int, default=1)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize G/D activations in the backward")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "convs", "d_only"],
                   help="with --remat: 'full' saves nothing; 'convs' saves "
                        "conv/matmul outputs and recomputes only the cheap "
                        "elementwise chains, which the epilogue kernels "
                        "already do (no region is added); 'd_only' "
                        "checkpoints only D's forwards (the GP "
                        "double-backward path)")
    p.add_argument("--gp-mode", default="reverse",
                   choices=["reverse", "jvp"],
                   help="GP gradient structure: 'reverse' = nested grad "
                        "(reference-exact op order); 'jvp' = the JVP-form "
                        "surrogate (same gradient)")
    p.add_argument("--fused-g", action="store_true",
                   help="FusedProp simultaneous update: one joint gradient "
                        "pass produces both networks' gradients (G steps "
                        "against the pre-update D)")
    p.add_argument("--gp-every", type=int, default=1,
                   help="lazy regularization: apply the gradient penalty "
                        "every N iterations with lambda scaled by N "
                        "(1 = reference-exact)")
    p.add_argument("--weights-cast", default="site",
                   choices=["site", "once"],
                   help="bf16 runs: scale+cast the f32 master weights at "
                        "every conv (site) or once per forward (once)")
    p.add_argument("--init-step", type=int,
                   default=defaults.get("init_step", 1))
    p.add_argument("--max-step", type=int,
                   default=defaults.get("max_step", 3))
    p.add_argument("--total-iter", type=int,
                   default=defaults.get("total_iter", 90000))
    p.add_argument("--pixel-norm", dest="pixel_norm", action="store_true",
                   default=defaults.get("pixel_norm", True))
    p.add_argument("--no-pixel-norm", dest="pixel_norm", action="store_false")
    p.add_argument("--tanh", dest="tanh", action="store_true",
                   default=defaults.get("tanh", True))
    p.add_argument("--no-tanh", dest="tanh", action="store_false")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-every", type=int,
                   default=defaults.get("sample_every", 1000))
    p.add_argument("--checkpoint-every", type=int,
                   default=defaults.get("checkpoint_every", 10000))
    p.add_argument("--log-every", type=int,
                   default=defaults.get("log_every", 500))
    p.add_argument("--no-mesh", dest="use_mesh", action="store_false",
                   default=True)
    p.add_argument("--fid-every", type=int, default=0,
                   help="in-training quality gate: FID of the EMA generator "
                        "every N iterations, appended to fid_score.json "
                        "(0 = off)")
    p.add_argument("--fid-samples", type=int, default=1024)
    p.add_argument("--inception-weights", type=str, default=None,
                   help="pytorch_fid/torchvision InceptionV3 state_dict for "
                        "--fid-every (without it a random-init extractor is "
                        "used: trends are meaningful, absolute scale is not)")
    p.add_argument("--steps-per-call", type=_steps_per_call, default=1,
                   help="run N iterations per call (a window; 'auto' "
                        "times each stage's first steps and picks N)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-axis shards over N ranks of --multihost "
                        "(the world must divide by N and the batch by the "
                        "world)")
    p.add_argument("--model-parallel-mode", default="channels",
                   choices=["channels", "spatial"],
                   help="with --model-parallel > 1: channels (the train "
                        "state's channels split over the model axis) or "
                        "spatial (every image split over H across it, halo "
                        "exchanges around each 3x3 conv and resampling; the "
                        "state whole; stages shorter than the axis split "
                        "the batch only)")
    p.add_argument("--checkpoint-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="full-train-state format: npz (the default: the "
                        "{iter}_g.model / _d.model param files and "
                        "{iter}_state.pt) or orbax (the npz pair and "
                        "the full state in the step-indexed store, "
                        "written in the background)")
    p.add_argument("--multihost", action="store_true",
                   help="one process per rank (per card), joined through "
                        "--coordinator-address; --batch-size is global, "
                        "split over the ranks")
    p.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--spans", type=str, default=None, metavar="PATH",
                   help="record the run's spans (data waits, checkpoints, "
                        "grids, the step's phases) and write them to PATH "
                        "at exit as a Chrome trace (pgx_torch.utils.trace)")
    return p


def maybe_init_multihost(args) -> None:
    """Call before any device use.  With ``--multihost`` this process joins
    the process group of ``--num-processes`` ranks as ``--process-id``
    through ``--coordinator-address`` (process 0's ``host:port``): NCCL on
    a card, gloo on the CPU (``pgx_torch.parallel.initialize_multihost``),
    and ``args.device`` becomes the rank's device (``cuda:{rank %
    device_count}``).  ``--batch-size`` is then the global batch."""
    if getattr(args, "multihost", False):
        from pgx_torch.parallel.distributed import initialize_multihost
        rank, world, dev = initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id,
            device=args.device)
        args.device = str(dev)
        print(f"multihost: process {rank}/{world} on {dev}", flush=True)


def get_dataset(args, kind: str, num_classes: int = 0):
    if args.path == "sklearn-digits":
        # real handwritten digits bundled with scikit-learn (no egress);
        # replicated to RGB for the color model families
        ds = load_sklearn_digits(rgb=(kind != "mnist"))
    elif args.synthetic or args.path is None:
        channels = 1 if kind == "mnist" else 3
        ds = synthetic_dataset(n=max(4 * args.batch_size, 256), size=32,
                               channels=channels,
                               num_classes=num_classes, seed=args.seed)
    elif kind == "mnist":
        ds = load_mnist(args.path)
    elif kind == "cifar10":
        ds = load_cifar10(args.path)
    else:
        raise ValueError(kind)
    limit = getattr(args, "limit_images", None)
    if limit:
        ds = ds.subset(limit, seed=args.seed)
    return ds


def add_stage_batch_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """--stage-batches for the images-seen (proper) schedulers: Karras et
    al. trained with large minibatches at low resolutions; the schedule is
    images-seen, so a bigger early batch means proportionally fewer
    iterations over the same data budget."""
    p.add_argument("--stage-batches", type=str, default=None,
                   metavar="RES:BATCH,...",
                   help="per-resolution batch sizes for the images-seen "
                        "schedule, e.g. '4:512,8:256,16:128' (unlisted "
                        "resolutions use --batch-size).  Same per-iteration "
                        "math; the data budget just divides into fewer, "
                        "bigger iterations at the listed stages")
    return p


def parse_stage_batches(spec, max_step: int, init_step: int = 1):
    """'4:512,8:256' -> {step: batch} for ProperSchedule (res = 4*2**(s-1));
    None/empty spec -> None."""
    if not spec:
        return None
    out = {}
    for item in spec.split(","):
        res_s, _, batch_s = item.partition(":")
        res, batch = int(res_s), int(batch_s)
        if batch < 1:
            raise ValueError(f"--stage-batches: batch {batch} < 1 at {item}")
        step = (res // 4).bit_length()  # 4 -> 1, 8 -> 2, ...
        if res != 4 * 2 ** (step - 1) or not (1 <= step <= max_step):
            raise ValueError(
                f"--stage-batches: resolution {res} is not a stage of this "
                f"4..{4 * 2 ** (max_step - 1)}px schedule")
        if step < init_step:
            continue  # stage never trained from this init_step
        out[step] = batch
    return out or None


def add_ada_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """ADA pipeline flags, shared by every training CLI."""
    p.add_argument("--ada", action="store_true",
                   help="wire the ADA augmentation pipeline + adaptive-p "
                        "controller (bgc policy)")
    p.add_argument("--ada-p", type=float, default=None, metavar="P",
                   help="run the augmentation pipeline at a FIXED "
                        "probability P (no adaptive controller) — the ADA "
                        "paper's fixed-p ablation mode; mutually exclusive "
                        "with --ada")
    p.add_argument("--ada-target", type=float, default=0.6)
    p.add_argument("--ada-length", type=int, default=500000)
    p.add_argument("--ada-warp", default="shear",
                   choices=["shear", "gather"],
                   help="geometric-warp backend: 'shear' = the fast "
                        "path (exact except bounded deviation on "
                        "rotations; kernel F); 'gather' = the bit-parity "
                        "oracle (kernel D)")
    return p


def ada_configs_from_args(args):
    """(augment_cfg, ada_cfg, augment_p) for train_loop.

    ``--ada`` enables the adaptive-p controller; ``--ada-p P`` enables the
    pipeline at a fixed probability with no controller (ada_cfg=None, the
    loop's ``augment_p`` applies — wgan.py's fixed-p path).  Neither flag
    -> (None, None, 1.0) and the step runs augmentation-free."""
    fixed_p = getattr(args, "ada_p", None)
    adaptive = getattr(args, "ada", False)
    if fixed_p is not None and adaptive:
        raise SystemExit("--ada and --ada-p are mutually exclusive: the "
                         "controller would overwrite the fixed probability")
    if fixed_p is not None and not 0.0 <= fixed_p <= 1.0:
        raise SystemExit(f"--ada-p must be in [0, 1], got {fixed_p}")
    if not adaptive and fixed_p is None:
        return None, None, 1.0
    from pgx_torch.augment import AdaConfig, bgc_config
    aug = bgc_config(warp_impl=getattr(args, "ada_warp", "shear"))
    if fixed_p is not None:
        return aug, None, fixed_p
    return (aug,
            AdaConfig(ada_target=args.ada_target,
                      ada_length=args.ada_length),
            1.0)


def loop_config_from_args(args, **extra):
    """LoopConfig from the shared CLI flags (``extra``: a CLI's own fields,
    such as mnist_train's ``tail_iterations``)."""
    from pgx_torch.train.loop import LoopConfig
    return LoopConfig(
        trial_name=args.trial_name, main_path=args.main_path,
        batch_size=args.batch_size, sample_every=args.sample_every,
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
        seed=args.seed, use_mesh=args.use_mesh,
        fid_every=args.fid_every, fid_samples=args.fid_samples,
        inception_weights=args.inception_weights,
        steps_per_call=args.steps_per_call,
        model_parallel=args.model_parallel,
        model_parallel_mode=args.model_parallel_mode,
        checkpoint_backend=args.checkpoint_backend, **extra)


def train_config_from_args(args):
    """TrainConfig from the shared CLI flags.

    Every training entry point builds the identical field set; keeping it
    here means a new TrainConfig field is one edit, not eight (and a CLI
    can't silently drop a flag argparse accepted).
    """
    from pgx_torch.train import TrainConfig
    return TrainConfig(learning_rate=args.lr, n_critic=args.n_critic,
                       gp_every=args.gp_every, gp_mode=args.gp_mode,
                       fused_g=args.fused_g, remat=args.remat,
                       remat_policy=args.remat_policy,
                       weights_cast=getattr(args, "weights_cast", "site"))


def run_trainer(args, gcfg, dcfg, schedule, dataset, batch_fn=None,
                **loop_extra) -> str:
    """The tail every training entry point shares: ``train_loop`` on
    ``args.device`` with the TrainConfig, the LoopConfig (``loop_extra``:
    a CLI's own fields) and the ADA configs from the flags.  ``batch_fn``
    is passed only when the CLI has its own (the loop's default is
    ``array_batches``).  Returns the trial directory."""
    augment_cfg, ada_cfg, augment_p = ada_configs_from_args(args)
    kw = {} if batch_fn is None else {"batch_fn": batch_fn}
    with trace.recording_to(args.spans):
        trial_dir = train_loop(gcfg, dcfg, train_config_from_args(args),
                               schedule, dataset,
                               loop_config_from_args(args, **loop_extra),
                               resume_dir=args.resume,
                               augment_cfg=augment_cfg, ada_cfg=ada_cfg,
                               augment_p=augment_p, device=args.device, **kw)
    print(f"done: {trial_dir}")
    return trial_dir
