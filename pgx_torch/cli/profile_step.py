"""Profiling entry point on a CUDA device (counterpart of
``pgx/cli/profile_step.py``): a ``torch.profiler`` trace of the flagship
train step, then its time per step.

    python -m pgx_torch.cli.profile_step --out pgx_trace [--steps 5]

One warm-up step runs outside the trace; the trace covers ``--steps``
steps and is written into ``--out`` through the TensorBoard handler
(``tensorboard --logdir pgx_trace``, or load the ``.pt.trace.json`` in
Perfetto); then ``--steps`` more steps are timed between two
``torch.cuda.synchronize`` calls and ms/step and img/s printed, with the
least, median and largest step (CUDA events between the steps; the host's
clock on the CPU).  Step 6 is
the 128px flagship (``zoo.conditional_correct_generator`` +
``conditional_correct_discriminator_wgangp``, channel 512); steps 7-9 use
the grown plan (``zoo.conditional_correct_grown``).  ``--device cpu`` runs
the kernels' plain PyTorch versions on the CPU (traced without CUDA
activity).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pgx_torch.models import zoo
from pgx_torch.train import TrainConfig, draw_z_eps, init_train_state, \
    make_train_step
from pgx_torch.utils import resolve_device


def flagship_configs(step: int, dtype: str):
    """The flagship pair at ``step``: the 128px family up to step 6, the
    grown halving plan past it."""
    if step <= 6:
        return (zoo.conditional_correct_generator(
                    z_dim=512, num_classes=10, channel=512, max_step=6,
                    dtype=dtype),
                zoo.conditional_correct_discriminator_wgangp(
                    feat_dim=512, num_classes=10, max_step=6, dtype=dtype))
    return zoo.conditional_correct_grown(step, dtype=dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="pgx_trace")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--step", type=int, default=6,
                   help="growth stage (6 = 128px flagship; 7-9 use the "
                        "grown zoo.conditional_correct_grown plan)")
    p.add_argument("--gp-mode", default="reverse",
                   choices=["reverse", "jvp"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to profile (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    gcfg, dcfg = flagship_configs(args.step, args.dtype)
    tc = TrainConfig(gp_mode=args.gp_mode, remat=args.remat)
    state = init_train_state(gcfg, dcfg, tc, seed=0, device=dev)
    rng = np.random.RandomState(0)
    res = gcfg.resolution(args.step)
    real = torch.from_numpy(rng.randn(args.batch_size, res, res, 3)
                            .astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(0, gcfg.num_classes,
                                          args.batch_size)).to(dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    step_fn = make_train_step(gcfg, dcfg, tc, step=args.step, fading=False)

    def stamp():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def run(n, marks=None):
        metrics = None
        for _ in range(n):
            if marks is not None:
                marks.append(stamp())
            z, eps = draw_z_eps(gcfg, args.batch_size, draws)
            _, metrics = step_fn(state, real, labels, 1.0, z=z, eps=eps)
        if marks is not None:
            marks.append(stamp())
        float(metrics["d_total"])     # waits for the last step
        if cuda:
            torch.cuda.synchronize()

    run(1)                            # warm-up outside the trace
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.out)):
        run(args.steps)

    marks = []
    t0 = time.perf_counter()
    run(args.steps, marks)
    dt = (time.perf_counter() - t0) / args.steps
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in zip(marks, marks[1:])]
    print(f"trace written to {args.out}; "
          f"{dt * 1e3:.1f} ms/step = {args.batch_size / dt:.1f} img/s; "
          f"steps {min(step_ms):.1f} / {float(np.median(step_ms)):.1f} / "
          f"{max(step_ms):.1f} ms (least / median / largest of "
          f"{args.steps})")
    return {"trace_dir": args.out, "iterations": 1 + 2 * args.steps,
            "ms_per_step": dt * 1e3, "img_per_s": args.batch_size / dt,
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
