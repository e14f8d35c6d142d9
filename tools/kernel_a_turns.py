#!/usr/bin/env python3
"""Kernel A's family and the steps that run it: this checkout against
another tree on one CUDA card, in turns.

    python tools/kernel_a_turns.py OTHER_TREE [--out FILE]

OTHER_TREE is an unpacked copy of another commit of this repository
(``git archive <commit> | tar -x -C DIR``), e.g. the parent of a kernel
change.  The call shapes are recorded once, with this checkout's
``chip_smoke.py``: every launch of kernels A, B, A's backward and A's second
derivative in one bf16 serving forward (batch 64), one bf16 128px training
iteration (batch 32), one sampling batch of 50 at 128px (the sweep's and
the FID tick's) and one bf16 512px jvp penalty iteration of the production
recipe (batch 8).  Then four child processes, in the order other, this,
this, other, each import the package and ``chip_smoke.py`` of their tree
(building its kernel library) and time, in bf16:

- each recorded shape's launch on the device (``chip_smoke.graph_ms``: 20
  launches captured in a CUDA graph and replayed, after one untimed graph),
  summed per path and kernel over the recorded launches, and for the
  second derivative also per shape (``per_shape``, keyed ``NxHxWxC``) and
  in f32 back to back (``f32_b2b_ms``: CUDA events, median of 10);
- one 128px training iteration (device ms: CUDA events, median of 7; host
  wall ms: synchronized, median of 5);
- one ``gp_every`` group of the 512px recipe with the jvp penalty, per
  iteration (the same two clocks, median of 3).

Each child prints one JSON line; the last line holds, for each tree, the
mean of its two turns and both turns.  Needs one card; the tree's
``build/`` directory holds its library.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root):
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, cs


def record(out_path: str) -> None:
    """The shapes, from this checkout."""
    torch, cs = _load(HERE)
    from pgx_torch.eval import sweep
    from pgx_torch.models.generator import Generator

    def rows(calls):
        return [[name, list(shape), json.loads(opts)["slope"]]
                for name, shape, _, opts in calls
                if name in (cs.A, cs.B, cs.A_BWD)]
    cfg, dcfg, params, serve = cs.flagship(torch)
    train, train_second = cs.record_train_calls(torch, cfg, dcfg)
    gen = Generator.from_jax_params(cfg, params, cs.DEVICE)
    sample = cs.record_calls(torch, lambda: sweep.generate_samples(
        gen, cfg, step=cfg.max_step, alpha=1.0, fading=False,
        num_samples=cs.EVAL_BATCH, batch_size=cs.EVAL_BATCH, seed=0,
        num_classes=cfg.num_classes))
    del gen
    r512, r512_second, _ = cs.record_a_calls_512(
        torch, *cs.recipe_pair("bfloat16"))
    with open(out_path, "w") as f:
        json.dump({"paths": {"serve_forward_b64": rows(serve),
                             "train_128px_b32": rows(train),
                             "eval_sampling_b50": rows(sample),
                             "train_512px_jvp_b8": rows(r512)},
                   "second": {"train_128px_b32": train_second,
                              "train_512px_jvp_b8": r512_second}}, f)


def child(root: str, shapes_path: str) -> dict:
    """Time the recorded shapes and the two steps with ``root``'s tree."""
    torch, cs = _load(root)
    from pgx_torch.ops.kernels import epilogue
    from pgx_torch.train import make_train_step
    pn = importlib.import_module("pgx_torch.ops.kernels.pixel_norm_lrelu")
    with open(shapes_path) as f:
        rec = json.load(f)
    rng = torch.Generator(device=cs.DEVICE).manual_seed(0)

    def rand(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=rng, device=cs.DEVICE)
                * scale).to(dtype)

    def device_ms(fn):
        with torch.inference_mode():
            return cs.graph_ms(torch, fn)

    def launcher(name, shape, slope):
        y, b, g = rand(shape), rand(shape[-1:], torch.float32, 0.1), \
            rand(shape)
        return {cs.A: lambda: epilogue._launch(y, b, slope, 1e-8),
                cs.B: lambda: pn._launch(y, slope, 1e-8),
                cs.A_BWD: lambda: epilogue._launch_backward(
                    y, b, g, slope, 1e-8)}[name]

    def second_launcher(shape, slope, has_ddy, has_ddb, needs,
                        dtype=torch.bfloat16):
        y, g = rand(shape, dtype), rand(shape, dtype)
        b = rand(shape[-1:], torch.float32, 0.1)
        ddy = rand(shape, dtype) if has_ddy else None
        ddb = rand(shape[-1:], torch.float32) if has_ddb else None
        return lambda: epilogue._launch_second_order(
            y, b, g, ddy, ddb, slope, 1e-8, tuple(needs))

    # the process's first graphs run slower: one untimed replay of a shape
    device_ms(launcher(*rec["paths"]["serve_forward_b64"][0]))
    kernels = {}
    for path, calls in rec["paths"].items():
        sums = kernels.setdefault(path, {})
        for key, n in collections.Counter(
                json.dumps(c) for c in calls).items():
            name, shape, slope = json.loads(key)
            ms = device_ms(launcher(name, shape, slope))
            agg = sums.setdefault(name, {"launches": 0, "device_ms": 0.0})
            agg["launches"] += n
            agg["device_ms"] += n * ms
    for path, calls in rec["second"].items():
        agg = kernels[path].setdefault(cs.A_BWD2, {
            "launches": 0, "device_ms": 0.0, "f32_b2b_ms": 0.0,
            "per_shape": {}})
        for key, n in collections.Counter(
                json.dumps(c) for c in calls).items():
            call = json.loads(key)
            ms = device_ms(second_launcher(*call))
            with torch.inference_mode():
                agg["f32_b2b_ms"] += n * cs.cuda_ms(torch, second_launcher(
                    *call, dtype=torch.float32))
            row = agg["per_shape"].setdefault(
                "x".join(map(str, call[0])), {"launches": 0,
                                              "device_ms": 0.0})
            for a in (agg, row):
                a["launches"] += n
                a["device_ms"] += n * ms

    steps = {}
    cfg, dcfg, _, _ = cs.flagship(torch)
    g, d, tc, state = cs.new_train_state(cfg, dcfg, "bfloat16")
    step = make_train_step(g, d, tc, step=cs.TRAIN_STEP, fading=False)
    real, labels, z, eps = cs.train_batch(torch, g, seed=300)

    def it128():
        step(state, real, labels, 1.0, z=z, eps=eps)
    steps["train_128px_b32"] = {
        "device_ms_per_iteration": cs.cuda_ms(torch, it128, reps=7),
        "host_wall_ms_per_iteration": cs.wall_ms(torch, it128)}
    del state, step
    torch.cuda.empty_cache()

    gcfg, dcfg = cs.recipe_pair("bfloat16")
    _, state, rsteps = cs.recipe_state(gcfg, dcfg, gp_mode="jvp")
    batches = [cs.recipe_draws(torch, gcfg, seed=1100 + j)
               for j in range(cs.R512_GP_EVERY)]

    def group():
        for j, (real, labels, draws) in enumerate(batches):
            rsteps[j == 0](state, real, labels, 1.0, **draws)
    steps["train_512px_jvp_b8"] = {
        "device_ms_per_iteration": cs.cuda_ms(torch, group, reps=3,
                                              warmup=1) / cs.R512_GP_EVERY,
        "host_wall_ms_per_iteration": cs.wall_ms(torch, group, reps=3)
        / cs.R512_GP_EVERY}
    return {"tree": root, "kernels": kernels, "steps": steps,
            "card": torch.cuda.get_device_name(0)}


def _mean_of_turns(turns):
    def merge(xs):
        if isinstance(xs[0], dict):
            return {k: merge([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], (int, float)) and not isinstance(xs[0], bool):
            return statistics.fmean(xs)
        return xs[0]
    return merge(turns)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other tree's root")
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--record", help=argparse.SUPPRESS)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.record:
        record(args.record)
        return 0
    if args.child:
        print(json.dumps(child(*args.child)), flush=True)
        return 0
    if not args.other:
        ap.error("OTHER_TREE is required")
    other = os.path.abspath(args.other)
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        shapes = os.path.join(tmp, "shapes.json")
        t0 = time.monotonic()
        subprocess.run([sys.executable, me, "--record", shapes], check=True,
                       cwd=HERE)
        emit({"recorded_s": time.monotonic() - t0})
        turns = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            root = other if who == "other" else HERE
            r = subprocess.run([sys.executable, me, "--child", root, shapes],
                               check=True, cwd=root, stdout=subprocess.PIPE,
                               text=True)
            got = json.loads(r.stdout.strip().splitlines()[-1])
            turns[who].append(got)
            emit({"turn": who, **got})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(),
          **{who: {"mean": _mean_of_turns(t), "turns": t}
             for who, t in turns.items()}})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
