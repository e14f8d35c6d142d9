#!/usr/bin/env python3
"""Chip smoke test of pgx_torch on one CUDA card.

    python3 chip_smoke.py

Every result is a printed line; ``python3 chip_smoke.py | tee FILE`` keeps
them.

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build   — build the CUDA kernel library from pgx_torch/ops/kernels/csrc;
   ptxas's registers, spills and shared memory for every kernel
   instantiation, and the resident grids of A's backward and second
   derivative at each width.
2. kernels — record the shapes the 128px flagship hands each kernel (A
   bias_pixelnorm_lrelu, B pixel_norm_lrelu, C conv3x3_epilogue and C's
   residual-emitting entry conv3x3_epilogue_r, and A's backward
   bias_pixelnorm_lrelu_bwd) in the generator's bf16 forward at batch 64
   and in one bf16 WGAN-GP training iteration at batch 32; at each, hold
   the kernel against its plain PyTorch version in f32 and bf16 (TF32 off;
   for the residual-emitting entry both y and r, for A's backward dy and
   db) and
   time kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA events, median after warmup).  Kernel A's
   second derivative (bias_pixelnorm_lrelu_bwd2) at each of its calls in
   the iteration's penalty against its plain closed form, with its device
   time from a CUDA graph and autograd through the plain backward beside
   it.  Then hold each wrapper's gradients against autograd through its
   plain version at one mid-size shape (kernel A also to second order,
   gradient-penalty shaped); one misaligned input through every kernel
   (copied, launched, held against the plain version); an empty kernel
   through kernel B's graph harness (the launch floor); and one bf16
   forward of legacy_generator(channel=16), whose 4-channel stages the
   kernels do not take, with launch counts from the routing rules.
3. serve   — write the full-width flagship (random weights, seed 0) as a
   trial directory, serve it in bf16 through GeneratorService and its HTTP
   front end, check the outputs and that every forward went through A, B
   and C, check the float forward against the plain path, and measure
   img/s at batch 64 and batch-1 latency.
   A torch.profiler pass splits the forward's device time by part.
4. train   — the full-width flagship G and D (seed 0), 128px, batch 32:
   one f32 iteration through the kernels against the same iteration with
   the plain versions swapped in (metrics and every gradient); bf16
   iterations, one of them fading, with finite metrics, moving parameters
   and EMA, and launch counts per iteration as the configs imply (kernel C
   never from the discriminator; A's backward 61 times: 50 first-order
   backwards and 11 repeats in the penalty's outer pass; its second
   derivative 12 times); then ms per iteration, img/s, peak memory (also
   with the second derivative's plain closed form swapped in) and a
   torch.profiler split of one iteration by part, with A's backward and
   its second derivative as labelled ranges.
5. ada     — kernels F (shift_1d), D (upfirdn2d), E (bias_act) and W
   (warp_resample, warp_down2 and their transposes): the launches of one
   bf16 ADA iteration at 128px, batch 32, are recorded for the shear warp
   (F, W) and for the gather warp (D); each kernel is held against its
   plain version there in f32 and bf16 and timed (D, F per axis, and W
   also by their own device time, replayed from a CUDA graph; F's y-shear
   on the column crop it reads in place, W2 on the y-shear's row crop), F
   also at the 256px and 512px extents (batch 2, both axes), W at the
   512px recipe's four calls (batch 8), D at the gather
   warp's four calls at 256px and 512px (batch 1), E for all nine
   activations with and without clamp at [32,128,128,256]; gradients of
   F and D (their backward launches the kernel) and of E (first and
   second order) against autograd through the plain versions; the crop
   copy the y-shear no longer makes, timed against the kernel.  Then the
   ops layer through its public functions (conv2d_resample with a
   separable filter -> bias_act) with launch counts from 0; the shear
   pipe in f32 against the same pipe with the plain versions swapped in;
   bf16 ADA iterations of the flagship (bgc policy, adaptive controller,
   shear warp) with launch counts per iteration asserted, finite metrics,
   the controller's state moving as ada_update implies, ms per iteration,
   img/s, peak memory, the pipe's own time and a torch.profiler split;
   and one iteration with the gather warp, which launches kernel D.
6. train_loop — the flagship's training CLI
   (``pgx_torch.cli.conditional_proper_cifar_train.main``) in this process
   at full width, bf16, batch 32, 64px fade/stable -> 128px fade/stable,
   fixed ADA p = 0.6 (shear warp, so kernel F runs), 3 iterations a
   mini-step, samples, checkpoints and log every 3 iterations, in a
   temporary directory the phase deletes; launch counts from 0 around it
   (every kernel but D and E launched); finite losses in every CSV row,
   64px then 128px in timing.json, 10 x 10 sample grids, the checkpoint
   files at the cadence.  Then the same CLI in a child process, sent
   SIGTERM once its first checkpoint is on disk, must exit 143 with an
   emergency full-state checkpoint, and ``--resume`` here must restart at
   that iteration and finish.  Reports img/s at 128px from timing.json
   beside the bare step's, the prefetcher's wait, peak memory, seconds and
   bytes per checkpoint write and the resumed run's first iteration.
   The in-process run also scores FID every 6 iterations (256 samples, at
   64px and at 128px) with any RuntimeWarning made an error: finite
   in-training entries in fid_score.json and fid_score_meta.json, each
   tick's seconds beside the log windows'.  The data path's C++ runtime
   (``pgx_torch.native``, built with g++ from the checkout's copy of the
   source) must be available: its build and load seconds are reported.
7. cli     — the remaining entry points of pgx_torch.cli, each in this
   process on the card with launch counts from 0 around it and one line
   (seconds, launches, the check's result), in temporary directories the
   phase deletes.  Each run's launches must equal what its configs
   predict, and every kernel call it makes is recorded where it launches
   (the records must account for every launch) and held against its
   plain version at that shape in bf16 and f32 at the standing
   tolerances, unless an earlier phase of the run held the same call;
   each line carries the errors.  cli.generate on the full-width flagship
   as a bf16 trial (--per-class 10: A 2, B 1, C 9 a batch of 50), its
   images against the same z through the plain versions (the serve
   phase's tolerance); cli.grow_checkpoint from that trial to the 512px
   recipe's widths (512,...,64,32, max_step 8), both equivalence checks
   passed at step 6 (three G and two D forwards); cli.profile_step at
   128px (batch 32) and at 512px with --gp-mode jvp (batch 8), launches
   per iteration as calls_per_iteration gives for its TrainConfig, a trace
   that names kernels A and C, ms per step over 10 timed steps with the
   least, median and largest, then each config again with its launches
   recorded; cli.augmentation_demo at 128px (F twice per p-row); each of
   the seven family trainers at its default widths on synthetic data, 4-6
   iterations over two stages, finite CSV rows, launches as
   calls_per_iteration at each iteration's step plus one generator
   forward per sample grid; cli.create_gif over one trainer's samples;
   cli.prepare_data square and facecrop on synthetic faces.
8. train_512_recipe — the 512px production recipe at full width
   (conditional_correct_grown(8, z_dim=512, channel=512), bf16, batch 8,
   ADA with the controller and the shear warp, gp_every 4, fused_g):
   kernel A's tangent (bias_pixelnorm_lrelu_jvp) at every call of one jvp
   penalty iteration against its plain version in f32 and bf16, with its
   device time from a CUDA graph, and its Function's backward against
   autograd through the plain rule; the f32 step at 512px in both penalty
   modes (jvp against reverse, and jvp through the kernels against jvp
   with the plain versions, against a noise yardstick); the bf16 step in
   both modes with launch counts per penalty and plain iteration asserted
   from the routing rules (reverse: no tangent; jvp: no double backward
   of a conv), ms per iteration over whole gp_every groups, img/s, peak
   memory, idle share; one window of make_train_multi_step(k=8) against 8
   single steps at learning rate 0, within 4x two runs' own spread (the
   card's atomics are not repeatable); peak memory and ms per iteration for each
   remat policy and weights_cast='once'; then the flagship's CLI with
   the recipe's flags (--gp-mode jvp --steps-per-call 8) through 256px
   and 512px, fade and stable, windows counted per phase, and a short run
   with --steps-per-call auto.
   The recipe phase also holds kernel A, B, A's backward and A's second
   derivative against their plain versions at every launch of one jvp
   penalty iteration (recorded where they launch, with the tangent's),
   with device time from a CUDA graph against the byte bound: sums per
   kernel and one row per shape (C, rows, device ms, bound, share); and
   kernel C's residual-emitting entry at its launches of the same
   iteration, in bf16 and f32, against its operations bound and cuDNN's
   conv + bias, summed and per shape.
9. eval    — at the flagship's full width: the device preprocess (PIL's
   bilinear fixed point as torch integer ops, the float chain by lookup)
   against the numpy path, bytes and floats equal, at 32px, 128px and
   grey; the card's f32 Inception features against the CPU's (1e-4 of the
   largest feature), unchanged with the caller's TF32 flags left on, and
   Inception's time per batch of 50 against its f32 bound; the flagship
   (random weights, seed 0) as a trial of one checkpoint, exported
   to reference .model files and imported back (--sample) byte for byte;
   ``pgx_torch.cli.fid_sweep --kid``, 2048 samples a side, on the imported
   trial (f32 sampling: its config carries no dtype) and on the bf16
   trial, each with launch counts from 0 (A 2, B 1, C 9 per sampling
   batch), nothing traced, finite FID and KID for the checkpoint, its
   seconds per checkpoint and the host time of each part (sampling,
   activations, sqrtm, KID); a second sweep that scores nothing; one bf16
   checkpoint scored again alone under torch.profiler (idle share); A, B
   and C against their plain versions at the sampling shapes of the sweep
   (batch 50) and of the loop's FID ticks (64px and 128px, batches 50 and
   6), in bf16 and f32; G's sampling per batch;
   ``pgx_torch.cli.fid_selftest`` on random weights (exit 2, then
   --allow-unverified).
10. export_store — the exported generator, the step-indexed store and the
   kernels' ops: the flagship's bf16 trial exported through
   ``pgx_torch.export.export_trial`` at buckets 1, 8 and 64, uint8 and
   float output (seconds per bucket, bytes); loaded in a fresh interpreter
   that imports only ``pgx_torch.export`` and holds no model, layer or
   training module, no pgx, no JAX; 64, 5 (padded) and 100 (chunked)
   images, each bucket call launching A 2, B 1, C 9 from counts at 0, and
   each result equal (difference 0) to the live ``make_eval_generate``
   forward at the same padded shapes; img/s at bucket 64, artifact and
   live forward in turns, beside phase 3's.  The flagship's train state
   (~0.95 GB) through the npz backend's synchronous ``*_state.pt`` and the
   step-indexed store: the caller's blocking time per save, the background
   write, three steps with a write in flight, a restore equal bit for bit;
   ``train_loop`` with ``checkpoint_backend='orbax'`` stopped after 2
   iterations and resumed from the store to 4.  The op route's host cost:
   B and A's forward back to back at the serving forward's calls, and the
   128px iteration, with the ops and with each op swapped for a direct call
   of its launch, in turns.
11. ddp     — data parallelism, on the one card.  NCCL at world 1 in this
   process: one bf16 128px flagship iteration (batch 32, reverse
   penalty, learning rate 0) through ``make_train_step(process_group=)``
   against the group-free iteration run twice: bit for bit on every
   tensor the card repeats (metrics, parameters, Adam moments, the EMA),
   the rest (G's gradients upstream of the atomics of its bilinear
   upsample's and label embedding's backward) within 4x the two runs'
   spread; launches per iteration as the configs imply, the all-reduce
   calls beside them.  ``GeneratorService(data_parallel=2)``
   raises pgx's ValueError on one card; the split-and-gather helper over
   ``[cuda:0, cuda:0]`` at buckets 1, 8 and 64 (A 2, B 1, C 9 per half),
   bit for bit against the halves forwarded one after the other and
   within the serve phase's tolerance of the whole batch (bitwise or not,
   reported), the service over that list against the one-device service,
   and Inception's batch split the same way (50 and a ragged 7).  Then two
   gloo ranks as subprocesses of this script (``--ddp-rank``), each
   importing only pgx_torch, the library built by phase 1: the f32
   flagship at 128px, global batch 32 (16 a rank), TF32 off, one reverse
   and one jvp iteration without and with ADA (shear warp) at learning
   rate 0 with the global draws handed in, metrics (1e-3) and D's and G's
   gradients (3e-2 of the largest entry, 5e-3 in the mean: the f32 train
   check's yardstick) against the same iteration at world 1 on rank 0;
   four bf16 ADA iterations with the controller, launches per iteration
   checked on each rank, then ``check_replica_consistency`` over the whole
   state, bit for bit; ms per iteration of each rank beside world 1 at
   batch 32 and 16 and the gradients' all-reduce per step (gloo through
   host memory on one card, not NCCL across cards); ``train_loop`` over
   the group (the phase initializes gloo; the CLI's ``--multihost`` would
   pick NCCL) with the flagship CLI's data, schedule and fixed ADA p, 64px
   for 4 iterations, then resumed to 8 at 128px, launches as the configs
   imply, the replicas bit for bit at the end of each run, rank 0 alone
   writing (the other rank's directory stays empty and the trial it is
   told to resume does not exist).
12. tp      — channel-sharded model parallelism on a (data, model) = (1, 2)
   grid of two gloo ranks on the one card (``--tp-rank`` subprocesses,
   importing only pgx_torch), the train state sharded over the model axis
   (``pgx_torch.parallel.tp``): the f32 flagship at 128px, global batch 32,
   TF32 off, learning rate 0, one reverse and one jvp iteration without
   and with ADA, metrics and the gathered D and G gradients against world
   1 on rank 0 at phase 11's yardstick; four bf16 ADA iterations with the
   controller, launches per iteration on each rank as the configs imply,
   the blocks and the gathered state bit for bit over the grid
   (``check_replica_consistency(mesh=)``), ms per iteration per rank, the
   state's bytes whole and at rest, and the step's gathers and reductions
   alone (ms and bytes); the 512px recipe at full width (global batch 8,
   jvp, gp_every 4, fused_g, ADA with the controller), its penalty and
   three plain iterations with launches per iteration checked, ms per
   iteration, each rank's state bytes at rest and peak memory, against
   world 1 at batch 8 and 4 on rank 0; the flagship CLI with
   ``--model-parallel 2`` (64px, 4 iterations, a checkpoint whose tensors
   are whole and equal to the last gathered state), then resumed at model
   1 in this process to 8 iterations at 128px, launches as the configs
   imply, rank 0 alone writing.  The same two ranks also run the spatial
   mode (its f32 variants after the channels mode's, its bf16 and 512px
   iterations before the CLI's loop) on a (1, 2) grid (``make_mesh_2d(..., mode='spatial')``: every
   image split over H, the state whole): the f32 variants against the same
   world-1 references, two bf16 ADA iterations of the flagship at the
   global batch 32 (launches per rank = world 1's, the state bit for bit
   over the ranks), the 512px recipe with the whole batch of 8 on each
   rank (its penalty and a plain iteration, launches checked, each rank's
   peak beside world 1's at batch 8 and 4, and under the former), and one
   more of each path with every halo exchange, gather and reduce-scatter
   waited for and timed (calls, ms, bytes a step).  Every kernel call of
   the recorded iterations, kernel C on its haloed tiles among them, is
   held against its plain version here.
13. card   — nvidia-smi's name and power limit.

Depth cut for phase 11's time: phase 9's trial holds one checkpoint (was
two); each checkpoint cost each sweep ~45 s of host sqrtm and KID.

Every bf16 kernel row of phase 2 also carries the kernel's device time
from a CUDA graph (``device_ms``), beside the back-to-back time (``ms``).

Prints JSON lines; the last two lines before the final one are the
kernels table (fourteen entries, each with ``launches_ddp`` and
``launches_tp``) and the card, the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

# one H100 SXM (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate,
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
F32_ELEMENTWISE_OPS = 67e12

A, B, C, C_R = ("bias_pixelnorm_lrelu", "pixel_norm_lrelu",
                "conv3x3_epilogue", "conv3x3_epilogue_r")
A_BWD = "bias_pixelnorm_lrelu_bwd"
A_BWD2 = "bias_pixelnorm_lrelu_bwd2"
A_JVP = "bias_pixelnorm_lrelu_jvp"
F_, D_, E_ = "shift_1d", "upfirdn2d", "bias_act"
W1, W1_T, W2, W2_T = ("warp_resample", "warp_resample_t", "warp_down2",
                      "warp_down2_t")
SOURCES = {
    A: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
        "pgx/ops/pallas/epilogue.py:97"),
    A_BWD: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
            "pgx/ops/pallas/epilogue.py:115-137 (transposed tangent rule)"),
    # pgx differentiates the tangent rule itself (plain jnp)
    A_BWD2: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
             "pgx/ops/pallas/epilogue.py:80-86 (second order of the "
             "custom_jvp's tangent rule)"),
    # the custom_jvp's tangent rule, which pgx's JVP penalty evaluates
    A_JVP: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
            "pgx/ops/pallas/epilogue.py:115-137 (the custom_jvp's tangent "
            "rule, _jvp_rule)"),
    B: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
        "pgx/ops/pallas/kernels.py:266"),
    C: ("pgx_torch/ops/kernels/csrc/conv_epilogue.cu",
        "pgx/ops/pallas/conv_epilogue.py:139"),
    # the same pallas_call, its emit_r=True variant (:133-138)
    C_R: ("pgx_torch/ops/kernels/csrc/conv_epilogue.cu",
          "pgx/ops/pallas/conv_epilogue.py:139"),
    # axis 3 at :125, axis 2 at :148: one CUDA kernel serves both
    F_: ("pgx_torch/ops/kernels/csrc/shear.cu",
         "pgx/ops/pallas/shear.py:125"),
    D_: ("pgx_torch/ops/kernels/csrc/upfirdn2d.cu",
         "pgx/ops/pallas/kernels.py:70"),
    E_: ("pgx_torch/ops/kernels/csrc/bias_act.cu",
         "pgx/ops/pallas/kernels.py:227"),
    # kernel W replaces no Pallas kernel: pgx leaves these einsums to XLA
    W1: ("pgx_torch/ops/kernels/csrc/warp_resample.cu",
         "none: pgx/ops/warp.py's pad + pass 1 einsums (XLA)"),
    W1_T: ("pgx_torch/ops/kernels/csrc/warp_resample.cu",
           "none: the transpose of pgx/ops/warp.py's pass 1 (XLA)"),
    W2: ("pgx_torch/ops/kernels/csrc/warp_resample.cu",
         "none: pgx/ops/warp.py's pass 4 einsums (XLA)"),
    W2_T: ("pgx_torch/ops/kernels/csrc/warp_resample.cu",
           "none: the transpose of pgx/ops/warp.py's pass 4 (XLA)"),
}
PER_FORWARD = {A: 2, B: 1, C: 9}
DEVICE = "cuda"           # every phase runs on the card
# every recorded call a phase has held against its plain version in this
# run: kernel_phase's and fde_phase's call tuples, (A_BWD2, *call) for
# second_order_phase's; the cli phase holds only calls not in it yet
HELD = set()
SERVE_BATCH = 64
TRAIN_BATCH = 32
TRAIN_STEP = 6            # 128px


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call: ``reps`` calls captured in one CUDA
    graph, the graph replayed between CUDA events (median of ``replays``),
    divided by ``reps``.  Every captured launch runs in every replay.  The
    host's time to enqueue a call, which back-to-back events include where a
    call is shorter than its enqueueing, is not in it; the graph's own
    dispatch from one launch to the next is."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # first calls outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, replays, warmup=1) / reps
    del graph
    return ms


def bf16_tol(ref_max: float) -> float:
    """Two bf16 steps at the largest output magnitude: the kernel rounds
    once, the plain version after each of its stages."""
    import math
    return 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 1e-3))) - 7)


def ptxas_usage(log: str) -> list:
    """Registers, spill bytes and static shared memory of every kernel
    instantiation in ptxas's report of the build (``build.ptxas_log``),
    the names demangled by c++filt where the machine has it."""
    import re
    import shutil
    rows, open_entry = [], False
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
            open_entry = True
            continue
        if not open_entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(m.group(1)),
                            smem_bytes=int(smem.group(1)) if smem else 0)
            open_entry = False
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = re.sub(r"\(.*", "", n.replace(
                    "(anonymous namespace)::", "")).removeprefix("void ")
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def swap_path_kernels(wrap):
    """Replace the kernel wrappers where the paths call them (layers for
    A and C, in the generator and the discriminator; the generator for B)
    with ``wrap(name, wrapper)``."""
    from pgx_torch.core import layers
    from pgx_torch.models import generator as G
    with contextlib.ExitStack() as stack:
        for mod, name in ((layers, C), (layers, A), (G, B)):
            stack.enter_context(mock.patch.object(
                mod, name, wrap(name, getattr(mod, name))))
        yield


def plain_versions():
    """The paths with the kernels' plain versions (a comparison on the
    card; the port itself has no such switch): A, B, C where the models
    call them, F, W, D, E where the warp and the ops layer call them."""
    import importlib
    from pgx_torch.ops import kernels as K
    from pgx_torch.ops import warp
    # the package exports functions of these names: take the modules
    ops_bias_act = importlib.import_module("pgx_torch.ops.bias_act")
    ops_upfirdn2d = importlib.import_module("pgx_torch.ops.upfirdn2d")

    def bias_act_plain(x, b, act, alpha, gain, clamp):
        return K.bias_act_ref(x, b, -1, act, alpha, gain,
                              clamp if clamp >= 0 else None)

    stack = contextlib.ExitStack()
    stack.enter_context(swap_path_kernels(
        lambda name, fn: getattr(K, name + "_ref")))
    for mod, name, plain in (
            (warp, "shift_1d", K.shift_1d_ref),
            (warp, "warp_resample", K.warp_resample_ref),
            (warp, "warp_down2", K.warp_down2_ref),
            (ops_upfirdn2d, "upfirdn2d_separable", K.upfirdn2d_ref),
            (ops_bias_act, "bias_act_channel_last", bias_act_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def record_calls(torch, run):
    """The (kernel, shape, weight shapes, options) calls ``run()`` makes,
    in order.  A call of kernel C that records a graph with pixel-norm is
    the residual-emitting entry's.  Kernel A's backward is recorded where
    its wrapper launches (every first-order backward of A)."""
    from pgx_torch.ops.kernels import epilogue
    calls = []
    launch_bwd = epilogue._launch_backward

    def rec_bwd(y, b, g, slope, eps):
        calls.append((A_BWD, tuple(y.shape), (tuple(b.shape),),
                      json.dumps({"slope": slope}, sort_keys=True)))
        return launch_bwd(y, b, g, slope, eps)

    def rec(name, fn):
        def wrapped(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            opts = dict(kw)
            opts.update({"slope": a for a in args if isinstance(a, float)})
            entry = name
            if (name == C and kw.get("use_pixel_norm", True)
                    and torch.is_grad_enabled()
                    and any(t.requires_grad for t in tensors)):
                entry = C_R
            calls.append((entry, tuple(tensors[0].shape),
                          tuple(tuple(t.shape) for t in tensors[1:]),
                          json.dumps(opts, sort_keys=True)))
            return fn(*args, **kw)
        return wrapped

    with swap_path_kernels(rec), mock.patch.object(
            epilogue, "_launch_backward", rec_bwd):
        run()
        torch.cuda.synchronize()
    return calls


def count_calls(calls) -> dict:
    counts = {}
    for c in calls:
        counts[c[0]] = counts.get(c[0], 0) + 1
    return counts


def kernel_phase(torch, calls, per: str, reps: int = 10):
    """Hold every kernel against its plain version at every distinct call
    of ``calls``, in bf16 and f32, and time both.  Returns the sums over
    the calls by (kernel, dtype)."""
    import math
    from pgx_torch.ops import kernels as K
    from pgx_torch.ops.kernels import epilogue

    g = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=DEVICE) * scale).to(
            dtype)

    uniq = {}
    for c in calls:
        uniq[c] = uniq.get(c, 0) + 1

    per_kernel = {}
    for (name, shape, wshapes, opts_s), mult in uniq.items():
        HELD.add((name, shape, wshapes, opts_s))
        opts = json.loads(opts_s)
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            es = torch.finfo(dt).bits // 8
            x = randn(*shape, dtype=dt)
            numel = x.numel()
            slope = opts.get("slope", 0.2)
            if name in (C, C_R):
                cin, cout = shape[-1], wshapes[0][-1]
                w = randn(3, 3, cin, cout, scale=math.sqrt(2 / (9 * cin)))
                b = randn(cout, scale=0.1)
                kw = {k: v for k, v in opts.items() if k != "slope"}
                kw["slope"] = slope
                m = numel // cin
                ops = 2.0 * m * 9 * cin * cout
                nbytes = (numel + 9 * cin * cout + cout + m * cout) * es
                if name == C_R:
                    kern = lambda: K.conv3x3_epilogue_with_r(
                        x, w, b, slope=slope)
                    plain = lambda: K.conv3x3_epilogue_ref(
                        x, w, b, return_r=True, slope=slope)
                    nbytes += m * 4         # r: one f32 per output pixel
                else:
                    kern = lambda: K.conv3x3_epilogue(x, w, b, **kw)
                    plain = lambda: K.conv3x3_epilogue_ref(x, w, b, **kw)
                peak = PEAK_OPS[dt_name]
                w_oihw = w.to(dt).permute(3, 2, 0, 1).contiguous()
                x_nchw = x.permute(0, 3, 1, 2)
                conv_only = lambda: torch.nn.functional.conv2d(
                    x_nchw, w_oihw, b.to(dt), padding=1)
            elif name == A_BWD:
                c = shape[-1]
                b = randn(c, scale=0.1)
                gy = randn(*shape, dtype=dt)
                kern = lambda: epilogue._launch_backward(x, b, gy, slope,
                                                         1e-8)
                plain = lambda: epilogue.bias_pixelnorm_lrelu_backward_ref(
                    x, b, gy, slope)
                # read y and g, write dy; the bias in, db (f32) out
                ops = 10.0 * numel
                nbytes = 3 * numel * es + c * es + c * 4
                peak = F32_ELEMENTWISE_OPS
                conv_only = None
            else:
                c = shape[-1]
                b = randn(c, scale=0.1)
                if name == A:
                    kern = lambda: K.bias_pixelnorm_lrelu(x, b, slope)
                    plain = lambda: K.bias_pixelnorm_lrelu_ref(x, b, slope)
                else:
                    kern = lambda: K.pixel_norm_lrelu(x, slope)
                    plain = lambda: K.pixel_norm_lrelu_ref(x, slope)
                ops = 6.0 * numel
                nbytes = 2 * numel * es + c * es
                peak = F32_ELEMENTWISE_OPS
                conv_only = None
            with torch.inference_mode():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                r_err = r_tol = db_err = None
                if name == A_BWD:
                    # db: an f32 sum over the rows in another order
                    (got, got_db), (want, want_db) = got, want
                    db_err = ((got_db - want_db).abs().max()
                              / want_db.abs().max()).item()
                    require(got_db.shape == want_db.shape
                            and math.isfinite(db_err) and db_err <= 1e-5,
                            f"{name} {shape} {dt_name}: db max rel err "
                            f"{db_err} > 1e-5")
                if name == C_R:
                    (got, got_r), (want, _) = got, want
                    # r = 1/rms of the f32 accumulator plus bias: compared
                    # relatively with the plain version's statistics in
                    # f32 on the inputs as the kernel takes them (x, and
                    # w and b in x's dtype).  The bf16 plain version's own
                    # r comes from a conv output rounded twice to bf16
                    # (conv, then + bias): at 8 output channels that r is
                    # itself 5e-3 off the f32 statistics
                    want_r = K.conv3x3_epilogue_ref(
                        x.float(), w.to(dt).float(), b.to(dt).float(),
                        return_r=True, slope=slope)[1]
                    r_tol = 1e-4
                    r_err = ((got_r - want_r).abs() / want_r).max().item()
                    require(got_r.shape == shape[:3] + (1,)
                            and got_r.dtype == torch.float32,
                            f"{name} {shape} {dt_name}: r shape/dtype")
                    require(math.isfinite(r_err) and r_err <= r_tol,
                            f"{name} {shape} {dt_name}: r max rel err "
                            f"{r_err} > tol {r_tol}")
                err = (got.float() - want.float()).abs().max().item()
                ref_max = want.float().abs().max().item()
                tol = (bf16_tol(ref_max) if dt_name == "bfloat16"
                       else 1e-4 if name in (C, C_R)
                       else 1e-5 * max(ref_max, 1.0) if name == A_BWD
                       else 1e-5)
                require(got.shape == want.shape and got.dtype == dt,
                        f"{name} {shape} {dt_name}: shape/dtype mismatch")
                require(math.isfinite(err) and err <= tol,
                        f"{name} {shape} {dt_name}: max abs err {err} > "
                        f"tol {tol}")
                del got, want
                ms = cuda_ms(torch, kern, reps)
                # back to back, the wrapper's host time shows where a call
                # is shorter than its enqueueing; the graph leaves it out
                device_ms = (graph_ms(torch, kern) if dt_name == "bfloat16"
                             else None)
                plain_ms = cuda_ms(torch, plain, reps)
                conv_ms = (cuda_ms(torch, conv_only, reps) if conv_only
                           else None)
            t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            rate = ({"tflop_per_s": ops / ms / 1e9} if name in (C, C_R)
                    else {})
            row = {"kernel": name, "shape": list(shape), "dtype": dt_name,
                   "calls": mult, "per": per, **opts, **rate,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "device_ms": device_ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "cudnn_conv_bias_ms": conv_ms}
            if r_err is not None:
                row.update(r_max_rel_err=r_err, r_tol=r_tol)
            if db_err is not None:
                row.update(db_max_rel_err=db_err, db_tol=1e-5)
            emit({"phase": "kernel_shape", **row})
            agg = per_kernel.setdefault((name, dt_name), {
                "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "t_ops": 0.0,
                "t_bytes": 0.0, "err": 0.0, "tol": 0.0, "conv_ms": 0.0,
                "calls": 0, "per_shape": []})
            agg["per_shape"].append({"shape": list(shape), "calls": mult,
                                     "wshapes": [list(w) for w in wshapes],
                                     "device_ms": device_ms,
                                     "bound_ms": max(t_ops, t_bytes),
                                     "cudnn_conv_bias_ms": conv_ms})
            agg["ms"] += mult * ms
            agg["device_ms"] += mult * (device_ms or 0.0)
            agg["plain_ms"] += mult * plain_ms
            agg["t_ops"] += mult * t_ops
            agg["t_bytes"] += mult * t_bytes
            agg["conv_ms"] += mult * (conv_ms or 0.0)
            agg["calls"] += mult
            if err >= agg["err"]:
                agg["err"], agg["tol"] = err, tol
    return per_kernel


def gradient_phase(torch):
    """Each wrapper's gradients (its hand-written backward) against
    autograd through its plain version, at one mid-size shape per kernel,
    f32 and bf16; kernel A also to second order, gradient-penalty shaped
    (f32).  Tolerance: relative to the largest entry of each gradient;
    f32 2e-4 (sums in another order), bf16 6e-2 (the backward rounds to
    bf16 once, autograd through the plain version at every op)."""
    import math
    from pgx_torch.ops import kernels as K

    rng = torch.Generator(device=DEVICE).manual_seed(3)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=rng, device=DEVICE)
                * scale).to(dtype)

    def grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad((fn(*leaves).float() * g).sum(), leaves)

    def worst(got, want):
        return max(((a.float() - e.float()).abs().max()
                    / e.float().abs().max().clamp_min(1e-12)).item()
                   for a, e in zip(got, want))

    out = {}
    for dt_name, tol in (("float32", 2e-4), ("bfloat16", 6e-2)):
        dt = getattr(torch, dt_name)
        y = randn(8, 32, 32, 256, dtype=dt)
        b = randn(256, scale=0.1)
        g = randn(8, 32, 32, 256)
        x = randn(8, 32, 32, 128, dtype=dt)
        w = randn(3, 3, 128, 256, scale=math.sqrt(2 / (9 * 128)))
        errs = {
            A: worst(grads(K.bias_pixelnorm_lrelu, (y, b), g),
                     grads(K.bias_pixelnorm_lrelu_ref, (y, b), g)),
            B: worst(grads(K.pixel_norm_lrelu, (y,), g),
                     grads(K.pixel_norm_lrelu_ref, (y,), g)),
            C_R: worst(grads(K.conv3x3_epilogue, (x, w, b), g),
                       grads(K.conv3x3_epilogue_ref, (x, w, b), g)),
        }
        for name, err in errs.items():
            require(math.isfinite(err) and err <= tol,
                    f"{name} {dt_name}: gradient max rel err {err} > {tol}")
        out[dt_name] = {"max_rel_err": errs, "tol": tol}

    y, b, g = randn(8, 16, 16, 256), randn(256, scale=0.1), randn(
        8, 16, 16, 256)

    def penalty_grads(fn):
        ty = y.clone().requires_grad_(True)
        tb = b.clone().requires_grad_(True)
        gy, = torch.autograd.grad((fn(ty, tb) * g).sum(), ty,
                                  create_graph=True)
        norms = gy.square().sum(dim=(1, 2, 3)).sqrt()
        return torch.autograd.grad(((norms - 1.0) ** 2).mean(), (ty, tb))

    err2 = worst(penalty_grads(K.bias_pixelnorm_lrelu),
                 penalty_grads(K.bias_pixelnorm_lrelu_ref))
    require(math.isfinite(err2) and err2 <= 2e-4,
            f"{A}: second-derivative max rel err {err2} > 2e-4")
    out["second_order_f32"] = {"max_rel_err": {A: err2}, "tol": 2e-4}

    # kernel C differentiates once only: a backward that records a graph
    # must raise
    tx = x.float().requires_grad_(True)
    yc = K.conv3x3_epilogue(tx, w, b)
    try:
        torch.autograd.grad(yc.sum(), tx, create_graph=True)
    except RuntimeError as e:
        require("differentiable once only" in str(e), f"unexpected: {e}")
    else:
        require(False, f"{C}: a double backward did not raise")
    torch.cuda.synchronize()
    return out


def routed_g_calls(gen, step: int) -> dict:
    """Kernel calls of one generator forward from its weights' shapes and
    the kernels' ``supported`` rules: B on the input layer where it takes
    the width; each padding-1 3x3 conv that no fused upsample precedes
    goes to C where C takes (C_in, C_out); every other conv to cuDNN, its
    epilogue to A where it pixel-normalizes and A takes C_out, else to the
    torch ops ("torch_ops" counts those, and a refused input layer)."""
    import torch
    from pgx_torch.ops.kernels import conv_epilogue, epilogue
    cfg = gen.cfg

    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=cfg.compute_dtype)
    b_ok = epilogue.supported(meta(1, 4, 4, cfg.channels[0]))
    counts = {A: 0, B: int(b_ok), C: 0, "torch_ops": int(not b_ok)}
    for k in range(cfg.out_stage(step) + 1):
        p = gen.blocks[str(4 * 2 ** k)]
        pn = cfg.pixel_norm or (k == 0 and cfg.arch == "proper")
        for i, conv in enumerate([p.conv1] + ([p.conv2] if hasattr(
                p, "conv2") else [])):
            cin, cout = conv.w.shape[2], conv.w.shape[3]
            up_fused = (i == 0 and k > 0 and cfg.fuse_up_conv_min_size
                        and 4 * 2 ** (k - 1) >= cfg.fuse_up_conv_min_size)
            if not up_fused and conv_epilogue.supported(
                    meta(1, 4, 4, cin), conv.w):
                counts[C] += 1
            elif pn and epilogue.supported(meta(1, 4, 4, cout)):
                counts[A] += 1
            else:
                counts["torch_ops"] += 1
    return counts


def routing_phase(torch):
    """One bf16 forward of legacy_generator(channel=16) at 256px, batch 8:
    its widths end in 8, 4, 4, which kernels A, B and C do not take.
    Launch counts from 0: what the weights' shapes and the kernels' rules
    imply (C where it takes the widths, A where only its width fits, the
    torch ops and cuDNN elsewhere); the output finite.  Held against the
    forward through the plain versions in f32, to 1e-3 of the largest
    output; in bf16 the mean error, to 2e-2 of it (a pixel norm over 4
    channels in bf16 turns one rounding of a small pixel into a different
    pixel, so single outputs differ by up to O(1))."""
    from pgx_torch.models import zoo
    from pgx_torch.models.generator import Generator, init_generator
    from pgx_torch.ops import kernels as K
    cfg = zoo.legacy_generator(z_dim=128, channel=16, dtype="bfloat16")
    step = cfg.max_step
    gen = Generator.from_jax_params(cfg, init_generator(cfg, seed=0),
                                    DEVICE)
    z = torch.randn(8, cfg.z_dim, generator=torch.Generator(
        device=DEVICE).manual_seed(31), device=DEVICE)
    routed = routed_g_calls(gen, step)
    want_counts = {k: routed[k] for k in (A, B, C)}
    require(want_counts[C] > 0 and routed["torch_ops"] > 0,
            f"legacy_generator(channel=16) routes {routed}")
    # ---- the routed path: counts from 0 to what it launched ----
    K.reset_launch_counts()
    with torch.inference_mode():
        got = gen(z, step=step)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # -------------------------------------------------------------
    require({k: launches[k] for k in want_counts} == want_counts
            and sum(launches.values()) == sum(want_counts.values()),
            f"legacy_generator(channel=16) launched {launches}, expected "
            f"{want_counts}")
    res = cfg.resolution(step)
    got = got.float()
    require(got.shape == (8, res, res, 3)
            and bool(torch.isfinite(got).all()),
            f"legacy_generator output {got.shape}")
    with plain_versions(), torch.inference_mode():
        want = gen(z, step=step).float()
    err = (got - want).abs().mean().item()
    tol = 2e-2 * want.abs().max().item()
    require(err <= tol, f"legacy_generator bf16 vs plain versions: mean "
                        f"abs err {err} > {tol}")
    gen32 = Generator.from_jax_params(dataclasses.replace(
        cfg, dtype="float32"), init_generator(cfg, seed=0), DEVICE)
    with torch.inference_mode():
        got32 = gen32(z, step=step)
        with plain_versions():
            want32 = gen32(z, step=step)
    err32 = (got32 - want32).abs().max().item()
    tol32 = 1e-3 * want32.abs().max().item()
    require(err32 <= tol32, f"legacy_generator f32 vs plain versions: "
                            f"{err32} > {tol32}")
    # the flagship's counts from the same rule
    fl = zoo.conditional_correct_generator(z_dim=512, num_classes=10,
                                           channel=512, max_step=6,
                                           dtype="bfloat16")
    with torch.device("meta"):
        fl_routed = routed_g_calls(Generator(fl), 6)
    require(fl_routed == {**PER_FORWARD, "torch_ops": 0},
            f"the routing rule gives the flagship {fl_routed}")
    return {"config": "legacy_generator(z_dim=128, channel=16), bf16, "
                      f"step {step} ({res}px), batch 8",
            "widths": list(cfg.channels), "launches": launches,
            "expected": routed, "bf16_mean_abs_err_vs_plain": err,
            "bf16_tol": tol, "f32_max_abs_err_vs_plain": err32,
            "f32_tol": tol32}


def misaligned_phase(torch):
    """One input per kernel whose data pointer is one element past a
    16-byte boundary (a contiguous view into a larger buffer): each
    wrapper copies it and launches; each result against the plain
    version, bf16, two bf16 steps at the largest output."""
    import math
    from pgx_torch.ops import bias_act, kernels as K
    from pgx_torch.ops.kernels import epilogue
    rng = torch.Generator(device=DEVICE).manual_seed(37)
    dt = torch.bfloat16

    def misaligned(*shape):
        flat = torch.randn(math.prod(shape) + 1, generator=rng,
                           device=DEVICE).to(dt)
        view = flat[1:].view(shape)
        require(view.is_contiguous() and view.data_ptr() % 16 != 0,
                "misaligned view")
        return view
    y, g, u = (misaligned(TRAIN_BATCH, 16, 16, 256) for _ in range(3))
    x = misaligned(TRAIN_BATCH, 16, 16, 128)
    img = misaligned(TRAIN_BATCH, 3, 576, 268)
    b = torch.randn(256, generator=rng, device=DEVICE) * 0.1
    w = torch.randn(3, 3, 128, 256, generator=rng, device=DEVICE) * (
        2.0 / (9 * 128)) ** 0.5
    shift = torch.linspace(-100.0, 100.0, 268, device=DEVICE).expand(
        TRAIN_BATCH, 268)
    taps = [1.0 / 12] * 12
    # kernel W at 64px: an image, its samples, the down-filter's input
    from pgx_torch.augment.pipe import _hz_geom
    from pgx_torch.ops import warp
    hz = tuple(float(v) for v in _hz_geom())
    sq = misaligned(TRAIN_BATCH, 64, 64, 3)
    crop = misaligned(TRAIN_BATCH, 3, 140, 140)
    th = torch.linspace(-3.0, 3.0, TRAIN_BATCH, device=DEVICE)
    params, _, _ = warp.resample_params(
        torch.stack([torch.stack([th.cos(), -th.sin()], -1),
                     torch.stack([th.sin(), th.cos()], -1)], 1),
        torch.zeros(TRAIN_BATCH, 2, device=DEVICE))
    cases = {
        A: (lambda: K.bias_pixelnorm_lrelu(y, b),
            lambda: K.bias_pixelnorm_lrelu_ref(y, b)),
        B: (lambda: K.pixel_norm_lrelu(y), lambda: K.pixel_norm_lrelu_ref(y)),
        C: (lambda: K.conv3x3_epilogue(x, w, b),
            lambda: K.conv3x3_epilogue_ref(x, w, b)),
        C_R: (lambda: K.conv3x3_epilogue_with_r(x, w, b)[0],
              lambda: K.conv3x3_epilogue_ref(x, w, b)),
        A_BWD: (lambda: epilogue._launch_backward(y, b, g, 0.2, 1e-8)[0],
                lambda: epilogue.bias_pixelnorm_lrelu_backward_ref(
                    y, b, g)[0]),
        A_BWD2: (lambda: epilogue._launch_second_order(
                     y, b, g, u, None, 0.2, 1e-8, (True, True, True))[0],
                 lambda: epilogue.second_order_ref(y, b, g, u, None)[0]),
        F_: (lambda: K.shift_1d(img, shift, 2),
             lambda: K.shift_1d_ref(img, shift, 2)),
        D_: (lambda: K.upfirdn2d_separable(x, taps, 2, 1, (6, 5, 6, 5)),
             lambda: K.upfirdn2d_ref(x, taps, 2, 1, (6, 5, 6, 5))),
        E_: (lambda: bias_act(y, b, act="lrelu"),
             lambda: K.bias_act_ref(y, b, -1, "lrelu")),
        # W against its plain version in f32 (warp_case)
        W1: (lambda: K.warp_resample(sq, params, 320, 512, hz),
             lambda: K.warp_resample_ref(sq.float(), params, 320, 512, hz)),
        W2: (lambda: K.warp_down2(crop, hz),
             lambda: K.warp_down2_ref(crop.float(), hz)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        before = K.launch_counts()[name]
        with torch.inference_mode():
            got, want = kern(), plain()
        torch.cuda.synchronize()
        require(K.launch_counts()[name] == before + 1,
                f"{name}: a misaligned input did not launch the kernel")
        err = (got.float() - want.float()).abs().max().item()
        tol = bf16_tol(want.float().abs().max().item())
        require(got.shape == want.shape and err <= tol,
                f"{name}: misaligned input, max abs err {err} > {tol}")
        out[name] = {"max_abs_err": err, "tol": tol}
    return out


def launch_floor_phase(torch, b_device_ms: float) -> dict:
    """An empty kernel launched through the same ctypes entry and the same
    CUDA-graph harness that times kernel B on the device (20 launches in
    one graph, replayed): the launch floor under B's time."""
    from pgx_torch.ops.kernels import build
    lib = build.load_library()

    def noop():
        build.check(lib.pgx_noop(build.stream_ptr()), "noop")
    device_ms = graph_ms(torch, noop)
    return {"empty_kernel_device_ms": device_ms,
            "empty_kernel_back_to_back_ms": cuda_ms(torch, noop, reps=10),
            "kernel_b_device_ms": b_device_ms,
            "kernel_b_over_floor_ms": b_device_ms - device_ms}


def crop_copy_phase(torch) -> dict:
    """The copies kernel F no longer makes in the 128px warp, bf16, batch
    32.  Before, shift_1d made each input contiguous first: the x-shear's,
    the einsum's permuted [32, 576, 3, 896] output seen as [32, 3, 576,
    896], and the y-shear's, the column crop ``v[..., 314:582]`` of the
    x-shear's output.  Now the kernel reads both in place.  Device times
    (CUDA graph): the copy, the kernel on the copy, the kernel on the
    view."""
    from pgx_torch.ops import kernels as K
    rng = torch.Generator(device=DEVICE).manual_seed(41)
    gamma = torch.rand(TRAIN_BATCH, 1, generator=rng, device=DEVICE) * 2 - 1
    views = {
        "x_shear_input": (torch.randn(
            TRAIN_BATCH, 576, 3, 896, generator=rng, device=DEVICE).to(
            torch.bfloat16).permute(0, 2, 1, 3), 3, 576),
        "y_shear_crop": (torch.randn(
            TRAIN_BATCH, 3, 576, 896, generator=rng, device=DEVICE).to(
            torch.bfloat16)[..., 314:314 + 268], 2, 268)}
    out = {"dtype": "bfloat16"}
    for name, (view, axis, lines) in views.items():
        shift = gamma * (torch.arange(lines, device=DEVICE)
                         - (lines / 2 - 0.5))
        copied = view.contiguous()
        with torch.inference_mode():
            got = K.shift_1d(view, shift, axis)
            want = K.shift_1d(copied, shift, axis)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"{name}: F differs on the view")
            copy_ms = graph_ms(torch, view.contiguous)
            on_copy_ms = graph_ms(torch, lambda: K.shift_1d(copied, shift,
                                                            axis))
            on_view_ms = graph_ms(torch, lambda: K.shift_1d(view, shift,
                                                            axis))
        out[name] = {
            "shape": list(view.shape), "strides": list(view.stride()),
            "copy_device_ms": copy_ms,
            "copy_bound_ms": 2 * view.numel() * 2 / HBM_BYTES_PER_S * 1e3,
            "kernel_on_copy_device_ms": on_copy_ms,
            "before_copy_plus_kernel_device_ms": copy_ms + on_copy_ms,
            "after_kernel_on_view_device_ms": on_view_ms}
    return out


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def write_trial(trial, cfg, params) -> None:
    from pgx_torch import checkpoint as ckpt
    os.makedirs(os.path.join(trial, "checkpoint"))
    # one mini-step per stage: iteration 20 is past the last stage, so the
    # service serves step 6 (128px) with alpha 1
    schedule = {"kind": "proper", "images_seen_per_mini_step": 1,
                "batch_size": 1, "max_step": cfg.max_step, "init_step": 1}
    with open(os.path.join(trial, "train_config_smoke.json"), "w") as f:
        json.dump({"generator": dataclasses.asdict(cfg),
                   "schedule": schedule}, f)
    ckpt.save_params(os.path.join(trial, "checkpoint",
                                  ckpt.checkpoint_name(20, "g")), params)


def forward_check(torch, cfg_bf16, params):
    """Kernel path vs plain path on the card, float output, batch 8, in
    bf16 and f32; and the device time of one batch-64 forward."""
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import make_eval_generate
    out = {}
    rng = torch.Generator(device=DEVICE).manual_seed(1)
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg_bf16, dtype=dt)
        gen = Generator.from_jax_params(cfg, params, DEVICE)
        fn = make_eval_generate(cfg, step=cfg.max_step, output="float")
        z = torch.randn(8, cfg.z_dim, generator=rng, device=DEVICE)
        lab = torch.arange(8, device=DEVICE) % cfg.num_classes
        got = fn(gen, z, lab).float()
        with plain_versions():
            want = fn(gen, z, lab).float()
        torch.cuda.synchronize()
        require(got.shape == (8, 128, 128, 3), f"{dt} forward shape")
        require(bool(torch.isfinite(got).all()), f"{dt} forward not finite")
        err = (got - want).abs().max().item()
        mean_err = (got - want).abs().mean().item()
        scale = want.abs().max().item()
        # bf16: 11 conv layers, each rounding at different points in the
        # two paths; f32: sums in another order (TF32 off on both sides)
        tol = (0.05 if dt == "bfloat16" else 1e-3) * scale
        require(err <= tol, f"{dt} forward vs plain path: max abs err "
                            f"{err} > {tol}")
        zb = torch.randn(SERVE_BATCH, cfg.z_dim, generator=rng,
                         device=DEVICE)
        lb = torch.arange(SERVE_BATCH, device=DEVICE) % cfg.num_classes
        fwd_ms = cuda_ms(torch, lambda: fn(gen, zb, lb), reps=5)
        with plain_versions():
            plain_fwd_ms = cuda_ms(torch, lambda: fn(gen, zb, lb), reps=5)
        out[dt] = {"max_abs_err": err, "mean_abs_err": mean_err,
                   "ref_max_abs": scale, "tol": tol,
                   "forward_b64_ms": fwd_ms,
                   "plain_forward_b64_ms": plain_fwd_ms}
        del gen
    return out


def g_calls_per_forward(cfg, step: int) -> dict:
    """Kernel calls of one generator forward, from the config: kernel B on
    the input layer; kernel C on every padding-1 3x3 conv that no fused
    upsample precedes; kernel A after each upsample + conv."""
    single = cfg.block_type == "single"
    counts = {A: 0, B: 1, C: 1 if (cfg.arch == "proper" or single) else 2}
    for k in range(1, cfg.out_stage(step) + 1):
        convs = 1 if single else 2
        in_res = 4 * 2 ** (k - 1)
        if cfg.fuse_up_conv_min_size and in_res >= cfg.fuse_up_conv_min_size:
            counts[A] += 1
            counts[C] += convs - 1
        else:
            counts[C] += convs
    return counts


def d_calls_per_forward(dcfg, step: int) -> int:
    """Kernel A calls of one discriminator forward: two convs on the 4x4
    block and on every stage of double blocks, one on a single block, each
    followed by A (D's epilogue pixel-normalizes; kernel C is G's)."""
    return sum(2 if (k == 0 or dcfg.block_type == "double") else 1
               for k in range(dcfg.entry_stage(step) + 1))


def calls_per_iteration(gcfg, dcfg, step: int, warp=None,
                        gp_mode: str = "reverse") -> dict:
    """Kernel launches of one training iteration, from the configs: four
    discriminator forwards (real, fake, x_hat; the G step's) of two convs
    per stage, each conv followed by kernel A, never kernel C; two
    generator forwards, the D step's without grad (C's plain entry) and
    the G step's under grad (C's residual-emitting entry).  With ADA the
    pipe runs three times (reals, the D step's fakes, the G step's fakes)
    and the G step differentiates its call: the shear warp launches F
    twice per call and twice in the backward (8), and kernel W's two passes
    once per call (3 each) and their transposes once in the backward; the
    gather warp launches D once per upsample2d and once per downsample2d,
    forward and backward (8).  Kernel E is not on the training path.

    Kernel A's backward runs wherever a first-order backward reaches A:
    the D step's real, fake and x_hat forwards and the G step's D forward
    (d_convs each), the G step's generator forward (g[A]), and once more in
    the penalty's outer pass, which differentiates the inner backward and
    so runs A's backward again for every A of the x_hat forward but the
    last, whose output reaches the score through linear layers only
    (d_convs - 1).  That outer pass runs A's second derivative once for
    every A of the x_hat forward (d_convs).

    With ``gp_mode='jvp'`` the penalty runs in place of the x_hat forward
    and its outer pass: the frozen inner forward and its backward (n A, n
    backwards), the dual forward's primal (n A) with n tangents, and in the
    reverse pass over the tangents n second derivatives, n backwards for
    the tangents' transposes and n for the primal chain (n = d_convs, the
    A calls of one D forward)."""
    g = g_calls_per_forward(gcfg, step)
    n = d_calls_per_forward(dcfg, step)
    jvp = gp_mode == "jvp"
    return {A: (5 if jvp else 4) * n + 2 * g[A],
            A_BWD: (6 * n if jvp else 5 * n - 1) + g[A], A_BWD2: n,
            A_JVP: n if jvp else 0, B: 2 * g[B], C: g[C], C_R: g[C],
            F_: 8 if warp == "shear" else 0,
            D_: 8 if warp == "gather" else 0, E_: 0,
            **shear_warp_calls(3 if warp == "shear" else 0,
                               1 if warp == "shear" else 0)}


def shear_warp_calls(forward: int, backward: int) -> dict:
    """Kernel W's launches for ``forward`` calls of the shear warp and
    ``backward`` backwards through it: each call launches W1 and W2 once,
    each backward their transposes."""
    return {W1: forward, W2: forward, W1_T: backward, W2_T: backward}


def flagship(torch):
    """The flagship configs (bf16), the generator's seeded weights and the
    kernel calls of one bf16 forward at batch 64."""
    from pgx_torch.models import zoo
    from pgx_torch.models.generator import Generator, init_generator

    cfg = zoo.conditional_correct_generator(
        z_dim=512, num_classes=10, channel=512, max_step=6,
        dtype="bfloat16")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    params = init_generator(cfg, seed=0)
    gen = Generator.from_jax_params(cfg, params, DEVICE)

    def forward():
        z = torch.randn(SERVE_BATCH, cfg.z_dim, device=DEVICE)
        lab = torch.arange(SERVE_BATCH, device=DEVICE) % cfg.num_classes
        with torch.inference_mode():
            gen(z, lab, step=cfg.max_step)

    calls = record_calls(torch, forward)
    require(count_calls(calls) == PER_FORWARD,
            f"kernel calls per forward {count_calls(calls)} != "
            f"{PER_FORWARD}")
    require(g_calls_per_forward(cfg, cfg.max_step) == PER_FORWARD,
            "kernel calls per forward derived from the config differ")
    return cfg, dcfg, params, calls


def profile_forward(torch, cfg, params, reps: int = 3):
    """Device time of the bf16 batch-64 forward by part (torch.profiler),
    and the host's wall time to issue and finish one forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import make_eval_generate
    gen = Generator.from_jax_params(cfg, params, DEVICE)
    fn = make_eval_generate(cfg, step=cfg.max_step, output="uint8")
    z = torch.randn(SERVE_BATCH, cfg.z_dim, device=DEVICE)
    lab = torch.arange(SERVE_BATCH, device=DEVICE) % cfg.num_classes
    for _ in range(2):
        fn(gen, z, lab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(gen, z, lab)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(gen, z, lab)
        torch.cuda.synchronize()
    parts = {"kernel C": "conv3x3_wgmma_kernel",
             "kernels A+B": "rownorm_kernel",
             "upsample": "upsample_bilinear", "cudnn conv": "xmma"}
    by_part = {k: 0.0 for k in [*parts, "other"]}
    for ev in prof.events():           # device-side events: kernels, copies
        if ev.device_type != DeviceType.CUDA:
            continue
        part = next((k for k, pat in parts.items() if pat in ev.name),
                    "other")
        by_part[part] += ev.time_range.elapsed_us() / 1e3 / reps
    total = sum(by_part.values())
    require(by_part["kernel C"] > 0 and total > 0,
            "profiler saw no device time for the forward")
    return {"device_ms_per_forward": total, "host_wall_ms_per_forward":
            host_ms, "by_part_ms": by_part}


def drive_service(torch, cfg, params):
    import io

    import numpy as np

    from pgx_torch.ops import kernels as K
    from pgx_torch.serve import GeneratorService, make_http_server

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        trial = os.path.join(tmp, "trial_smoke")
        write_trial(trial, cfg, params)
        t0 = time.monotonic()
        svc = GeneratorService(trial, device=DEVICE, max_batch=SERVE_BATCH)
        try:
            result["load_s"] = time.monotonic() - t0
            require(svc.state.step == 6 and svc.state.resolution == 128,
                    f"served state {svc.state}")
            t0 = time.monotonic()
            svc.warmup((1, None))
            result["warmup_s"] = time.monotonic() - t0
            server = make_http_server(svc, "127.0.0.1", 0)
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            try:
                # ---- the main path: counts from 0 to what it launched ----
                b0 = svc.stats()["batches"]
                K.reset_launch_counts()
                rng = np.random.RandomState(0)
                futs = []
                for n in (1, 7, 64):
                    z = rng.randn(n, cfg.z_dim).astype("float32")
                    lab = (rng.randint(0, cfg.num_classes, n)
                           .astype("int32"))
                    futs.append((n, svc.submit(z, lab)))
                outs = [(n, f.result(timeout=300)) for n, f in futs]
                conn = http.client.HTTPConnection(
                    "127.0.0.1", server.server_port, timeout=300)
                conn.request("GET", "/generate?num=16&format=npz&seed=3")
                r = conn.getresponse()
                body = r.read()
                conn.close()
                launches = K.launch_counts()
                forwards = svc.stats()["batches"] - b0
                # ----------------------------------------------------------
                require(r.status == 200, f"HTTP status {r.status}")
                with np.load(io.BytesIO(body)) as npz:
                    outs.append((16, npz["images"]))
                for n, img in outs:
                    require(img.dtype == np.uint8
                            and img.shape == (n, 128, 128, 3),
                            f"output {img.dtype} {img.shape} for n={n}")
                    require(int(img.max()) > int(img.min()),
                            "constant image")
                for name in launches:
                    per = PER_FORWARD.get(name, 0)
                    require(launches[name] == per * forwards,
                            f"{name}: {launches[name]} launches for "
                            f"{forwards} forwards (expect {per} each)")
                result.update(forwards=forwards, launches=launches)

                # ---- throughput and latency (after the counted run) ----
                z64 = rng.randn(SERVE_BATCH, cfg.z_dim).astype("float32")
                l64 = rng.randint(0, 10, SERVE_BATCH).astype("int32")
                lat64 = []
                for _ in range(10):
                    t0 = time.monotonic()
                    svc.submit(z64, l64).result(timeout=300)
                    lat64.append(time.monotonic() - t0)
                t0 = time.monotonic()
                fs = [svc.submit(z64, l64) for _ in range(20)]
                for f in fs:
                    f.result(timeout=300)
                pipelined = 20 * SERVE_BATCH / (time.monotonic() - t0)
                lat1 = []
                for i in range(30):
                    j = i % SERVE_BATCH
                    t0 = time.monotonic()
                    svc.submit(z64[j:j + 1], l64[j:j + 1]).result(
                        timeout=300)
                    lat1.append(time.monotonic() - t0)
                result.update(
                    img_per_s_b64_sequential=SERVE_BATCH
                    / statistics.median(lat64),
                    img_per_s_b64_pipelined=pipelined,
                    latency_b64_ms_p50=1e3 * statistics.median(lat64),
                    latency_b1_ms_p50=1e3 * statistics.median(lat1),
                    latency_b1_ms_max=1e3 * max(lat1),
                    max_wait_ms=1e3 * svc.max_wait_s,
                    samples={"b64": len(lat64), "b1": len(lat1),
                             "pipelined_batches": 20})
            finally:
                server.shutdown()
                server.server_close()
                th.join(timeout=30)
        finally:
            svc.close()
    return result


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def train_batch(torch, gcfg, seed: int):
    """One step's inputs on the card, from a seed: a real batch in
    [-1, 1], labels, z and eps."""
    from pgx_torch.train import draw_z_eps
    rng = torch.Generator(device=DEVICE).manual_seed(seed)
    res = gcfg.resolution(TRAIN_STEP)
    real = torch.randn(TRAIN_BATCH, res, res, 3, generator=rng,
                       device=DEVICE).clamp_(-1.0, 1.0)
    labels = torch.arange(TRAIN_BATCH, device=DEVICE) % gcfg.num_classes
    z, eps = draw_z_eps(gcfg, TRAIN_BATCH, rng)
    return real, labels, z, eps


def new_train_state(gcfg, dcfg, dtype: str):
    from pgx_torch.train import TrainConfig, init_train_state
    g = dataclasses.replace(gcfg, dtype=dtype)
    d = dataclasses.replace(dcfg, dtype=dtype)
    tc = TrainConfig()
    return g, d, tc, init_train_state(g, d, tc, seed=0, device=DEVICE)


@contextlib.contextmanager
def recording_second(second: list):
    """Append every launch of kernel A's second derivative (the gradient
    penalty's outer pass through A's backward, or the reverse pass over a
    jvp penalty's tangents) to ``second`` as (shape, slope, ddy given, ddb
    given, the outputs it needs), recorded where it launches."""
    from pgx_torch.ops.kernels import epilogue
    inner = epilogue._launch_second_order

    def rec_second(y, b, g, ddy, ddb, slope, eps, needs):
        second.append((tuple(y.shape), slope, ddy is not None,
                       ddb is not None, tuple(needs)))
        return inner(y, b, g, ddy, ddb, slope, eps, needs)

    with mock.patch.object(epilogue, "_launch_second_order", rec_second):
        yield


def record_train_calls(torch, gcfg, dcfg):
    """The kernel calls of one bf16 training iteration at batch 32, and
    every call of kernel A's second derivative (``recording_second``)."""
    from pgx_torch.train import make_train_step
    g, d, tc, state = new_train_state(gcfg, dcfg, "bfloat16")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False)
    real, labels, z, eps = train_batch(torch, g, seed=100)
    second = []
    with recording_second(second):
        calls = record_calls(
            torch, lambda: step(state, real, labels, 1.0, z=z, eps=eps))
    want = calls_per_iteration(g, d, TRAIN_STEP)
    got = {k: count_calls(calls).get(k, 0) for k in want if k != A_BWD2}
    got[A_BWD2] = len(second)
    require(got == want, f"kernel calls per iteration {got} != {want}")
    return calls, second


def second_order_phase(torch, second, reps: int = 5):
    """Kernel A's second derivative at each recorded call of one bf16
    iteration, with the call's cotangents and needed outputs: the kernel
    (``_BiasPixelNormLreluGrad2``'s forward) against its plain closed form
    (``second_order_ref``) in bf16 and f32 (f32 to 1e-5 of each output's
    largest entry; bf16 two bf16 steps, d_b an f32 sum to 1e-5 relative);
    the Function as the penalty's outer pass runs it (autograd through A's
    backward Function) against autograd through the plain first-order ops,
    two bf16 steps; times: the kernel back to back and on the device (CUDA
    graph), the plain closed form, and autograd through the plain backward
    (what the port ran before the backward became a kernel)."""
    import math
    from pgx_torch.ops.kernels import epilogue
    rng = torch.Generator(device=DEVICE).manual_seed(29)
    uniq = {}
    for c in second:
        uniq[c] = uniq.get(c, 0) + 1
    out = {"calls": len(second), "ms": 0.0, "device_ms": 0.0,
           "plain_ms": 0.0, "autograd_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
           "max_abs_err": 0.0, "tol": 0.0, "f32": {"ms": 0.0, "plain_ms": 0.0,
                                                   "t_bytes": 0.0,
                                                   "max_rel_err": 0.0},
           "per_shape": []}
    for (shape, slope, has_ddy, has_ddb, needs), mult in uniq.items():
        HELD.add((A_BWD2, shape, slope, has_ddy, has_ddb, needs))
        row = {"shape": list(shape), "calls": mult, "ddy": has_ddy,
               "ddb": has_ddb, "needs": list(needs)}
        c = shape[-1]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            es = torch.finfo(dt).bits // 8

            def rand(*sh, scale=1.0, dtype=dt):
                return (torch.randn(*sh, generator=rng, device=DEVICE)
                        * scale).to(dtype)
            y, gy = rand(*shape), rand(*shape)
            b = rand(c, scale=0.1, dtype=torch.float32)
            ddy = rand(*shape) if has_ddy else None
            ddb = rand(c, dtype=torch.float32) if has_ddb else None

            def kern():
                return epilogue._BiasPixelNormLreluGrad2.apply(
                    y, b, gy, ddy, ddb, slope, 1e-8, needs)

            def plain():
                return epilogue.second_order_ref(y, b, gy, ddy, ddb, slope,
                                                 1e-8, needs)
            with torch.inference_mode():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                worst, worst_rel, tol_at = 0.0, 0.0, 0.0
                for name, x, w in zip(("d_y", "d_b", "d_g"), got, want):
                    require((x is None) == (w is None), f"{A_BWD2} {name}")
                    if w is None:
                        continue
                    scale = w.float().abs().max().item()
                    err = (x.float() - w.float()).abs().max().item()
                    tol = (bf16_tol(scale) if dt_name == "bfloat16"
                           and name != "d_b" else 1e-5 * scale)
                    require(x.shape == w.shape and x.dtype == w.dtype
                            and math.isfinite(err) and err <= tol,
                            f"{A_BWD2} {shape} {dt_name} {name}: max abs err "
                            f"{err} > tol {tol}")
                    worst_rel = max(worst_rel, err / max(scale, 1e-30))
                    if name != "d_b" and err >= worst:
                        worst, tol_at = err, tol
                del got, want
                ms = cuda_ms(torch, kern, reps)
                device_ms = graph_ms(torch, kern) if dt_name == "bfloat16" \
                    else None
                plain_ms = cuda_ms(torch, plain, reps)
            # each tensor read once (y, g, ddy) or written once (d_y, d_g),
            # the bias, ddb (f32) and d_b (f32) C-wide
            n_full = 2 + has_ddy + needs[0] + needs[2]
            nbytes = (n_full * math.prod(shape) * es + c * es
                      + c * 4 * (has_ddb + needs[1]))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 30.0 * math.prod(shape) / F32_ELEMENTWISE_OPS * 1e3
            if dt_name == "float32":
                f = out["f32"]
                f["ms"] += mult * ms
                f["plain_ms"] += mult * plain_ms
                f["t_bytes"] += mult * max(t_bytes, t_ops)
                f["max_rel_err"] = max(f["max_rel_err"], worst_rel)
                row["f32"] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": max(t_bytes, t_ops),
                              "max_rel_err": worst_rel}
                continue
            # the Function where the penalty's outer pass runs it, against
            # autograd through the plain first-order ops (the old path)
            ty, tg = (t.clone().requires_grad_(True) for t in (y, gy))
            closed_dy, _ = epilogue._BiasPixelNormLreluGrad.apply(
                ty, b, tg, slope, 1e-8)
            a = (ty + b.to(ty.dtype)).float()
            plain_dy = epilogue.rownorm_lrelu_backward(
                a, tg.float(), slope, 1e-8).to(ty.dtype)
            u = ddy if has_ddy else rand(*shape)

            def closed():
                return torch.autograd.grad(closed_dy, (ty, tg), u,
                                           retain_graph=True)

            def autograd_plain():
                return torch.autograd.grad(plain_dy, (ty, tg), u,
                                           retain_graph=True)
            err = max((x.float() - w.float()).abs().max().item()
                      for x, w in zip(closed(), autograd_plain()))
            tol = max(bf16_tol(w.float().abs().max().item())
                      for w in autograd_plain())
            require(err <= tol, f"{A} second derivative {shape}: kernel "
                                f"vs autograd through the plain backward "
                                f"{err} > {tol}")
            autograd_ms = cuda_ms(torch, autograd_plain, reps)
            del closed_dy, plain_dy, a, ty, tg
            out["ms"] += mult * ms
            out["device_ms"] += mult * device_ms
            out["plain_ms"] += mult * plain_ms
            out["autograd_ms"] += mult * autograd_ms
            out["t_bytes"] += mult * t_bytes
            out["t_ops"] += mult * t_ops
            if worst >= out["max_abs_err"]:
                out["max_abs_err"], out["tol"] = worst, tol_at
            row.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       autograd_through_plain_backward_ms=autograd_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="operations" if t_ops > t_bytes else "bytes",
                       share_of_bound=max(t_bytes, t_ops) / device_ms,
                       max_abs_err=worst, tol=tol_at,
                       kernel_vs_autograd_err=err)
        out["per_shape"].append(row)
    out["bound_ms"] = max(out["t_bytes"], out["t_ops"])
    out["bound_by"] = ("operations" if out["t_ops"] > out["t_bytes"]
                       else "bytes")
    return out


@contextlib.contextmanager
def perturbed_fake(torch, rel: float):
    """The D step's fake batch (the generator's forward without grad) with
    seeded noise of ``rel`` times its largest value added: a yardstick for
    how far rounding-size differences in D's input move its gradients."""
    from pgx_torch.train import wgan
    inner = wgan.generator_apply

    def noisy(*args, **kw):
        out = inner(*args, **kw)
        if torch.is_grad_enabled():
            return out
        rng = torch.Generator(device=DEVICE).manual_seed(5)
        return out + rel * out.abs().max() * torch.randn(
            out.shape, generator=rng, device=DEVICE, dtype=out.dtype)

    with mock.patch.object(wgan, "generator_apply", noisy):
        yield


def train_f32_check(torch, gcfg, dcfg):
    """f32 iterations through the kernels against the same iterations with
    the plain versions swapped in, TF32 off.  With beta1 = 0 Adam's first
    moment after a step is that step's gradient, so ``mu`` of every
    parameter of D and G is what is compared, per tensor: the largest
    error relative to the tensor's largest entry, and the mean error
    relative to its mean magnitude.

    Two iterations per path, from one seeded state.  The first runs with
    learning rate 0, so both networks' gradients are taken at identical
    weights.  The second is a reference-exact iteration (learning rate
    1e-3): metrics must agree to 1e-3 relative (1e-4 absolute).

    Tolerance of the gradients: 3e-2 of the largest entry and 5e-3 in the
    mean.  It is set by the function, not by the kernels: at a random
    initialization the penalty's second-order gradient is so sensitive
    that noise of 3e-7 (one f32 rounding) on the fake batch alone, with
    the plain versions on both sides, moves D's gradients by up to 9e-3 of
    their largest entry (a leaky-ReLU branch that flips).  That yardstick
    is measured here too and printed beside the kernels' numbers.  In the
    second iteration G's gradients are taken against the UPDATED D, and
    Adam at beta1 = 0 moves every weight by lr * g / (|g| + 1e-8), which
    turns rounding-size differences in near-zero gradient entries into
    +-lr steps of D; they are held to 0.1 and reported."""
    import math
    from pgx_torch.train import make_train_step

    def run(context, iterations):
        g, d, tc, state = new_train_state(gcfg, dcfg, "float32")
        tcs = (dataclasses.replace(tc, learning_rate=0.0), tc)[:iterations]
        out = []
        with context:
            for i, tc_i in enumerate(tcs):
                step = make_train_step(g, d, tc_i, step=TRAIN_STEP,
                                       fading=False)
                real, labels, z, eps = train_batch(torch, g, seed=200 + i)
                _, metrics = step(state, real, labels, 1.0, z=z, eps=eps)
                torch.cuda.synchronize()
                out.append(({k: float(v) for k, v in metrics.items()},
                            {f"{net}.{n}": t.clone() for net in ("d", "g")
                             for n, t in state[f"opt_{net}"]["mu"].items()}))
        return out

    def worst_gradient(got, want, nets):
        worst = {"max_err_rel_to_largest_entry": 0.0, "tensor": None,
                 "mean_err_rel_to_mean": 0.0, "tensors_on_graph": 0}
        for name, w in want.items():
            if not name.startswith(nets):
                continue
            scale = w.abs().max().item()
            diff = (got[name] - w).abs()
            err = diff.max().item()
            require(math.isfinite(err), f"f32 gradient {name} not finite")
            if scale == 0.0:    # a parameter off the graph: zeros in both
                require(err == 0.0, f"f32 gradient {name}: off-graph, "
                                    f"nonzero")
                continue
            worst["tensors_on_graph"] += 1
            worst["mean_err_rel_to_mean"] = max(
                worst["mean_err_rel_to_mean"],
                diff.mean().item() / w.abs().mean().item())
            if err / scale >= worst["max_err_rel_to_largest_entry"]:
                worst["max_err_rel_to_largest_entry"] = err / scale
                worst["tensor"] = name
        return worst

    def hold(r, tol_max, tol_mean, what):
        require(r["max_err_rel_to_largest_entry"] <= tol_max
                and r["mean_err_rel_to_mean"] <= tol_mean,
                f"f32 gradients, {what}: {r} over ({tol_max}, {tol_mean})")

    k0, k1 = run(contextlib.nullcontext(), 2)
    p0, p1 = run(plain_versions(), 2)
    with plain_versions():
        n0, = run(perturbed_fake(torch, 3e-7), 1)

    report = {"same_weights": {
        "d": worst_gradient(k0[1], p0[1], ("d.",)),
        "g": worst_gradient(k0[1], p0[1], ("g.",)),
        "tol_max": 3e-2, "tol_mean": 5e-3,
        "yardstick_plain_vs_plain_with_3e-7_noise_on_the_fake": {
            "d": worst_gradient(n0[1], p0[1], ("d.",)),
            "g": worst_gradient(n0[1], p0[1], ("g.",))}}}
    hold(report["same_weights"]["d"], 3e-2, 5e-3, "D at identical weights")
    hold(report["same_weights"]["g"], 3e-2, 5e-3, "G at identical weights")
    m_k, m_p = k1[0], p1[0]
    worst_metric = 0.0
    for k, v in m_p.items():
        require(math.isfinite(m_k[k]), f"f32 metric {k} = {m_k[k]}")
        err = abs(m_k[k] - v)
        require(err <= 1e-4 + 1e-3 * abs(v),
                f"f32 metric {k}: kernels {m_k[k]} vs plain {v}")
        worst_metric = max(worst_metric, err / max(abs(v), 1e-4))
    report["iteration"] = {
        "metrics_kernels": m_k, "metrics_plain": m_p,
        "metric_max_rel_err": worst_metric, "metric_tol": 1e-3,
        "d": worst_gradient(k1[1], p1[1], ("d.",)),
        "g_against_updated_d": worst_gradient(k1[1], p1[1], ("g.",)),
        "g_tol_max": 0.1}
    hold(report["iteration"]["d"], 3e-2, 5e-3, "D in the full iteration")
    hold(report["iteration"]["g_against_updated_d"], 0.1, 0.1,
         "G against the updated D")
    return report


def profile_iteration(torch, run, reps: int = 2):
    """Device time of one bf16 training iteration by part (torch.profiler,
    kernels classified by name).  Kernel A's backward (first order: every
    call of the Function's backward, also the penalty's inner one and the
    repeat in its outer pass) and its second derivative (the penalty's
    outer pass through the inner backward) are read from labelled ranges
    around them.  Both kernels have their own parts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from pgx_torch.ops.kernels import epilogue

    first = epilogue._BiasPixelNormLrelu.backward
    second = epilogue._BiasPixelNormLreluGrad.backward

    def labelled_first(ctx, g):
        with record_function("kernel_a_backward"):
            return first(ctx, g)

    def labelled_second(ctx, ddy, ddb):
        with record_function("kernel_a_second_order"):
            return second(ctx, ddy, ddb)

    ranges = ("kernel_a_backward", "kernel_a_second_order")
    with mock.patch.object(epilogue._BiasPixelNormLrelu, "backward",
                           staticmethod(labelled_first)), \
            mock.patch.object(epilogue._BiasPixelNormLreluGrad, "backward",
                              staticmethod(labelled_second)):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    parts = {"kernel C (plain + emit-r)": ("conv3x3_wgmma_kernel",
                                           "conv3x3_fma_kernel"),
             "kernel A second order": ("rownorm_bwd2",),
             "kernel A backward": ("rownorm_bwd",),
             "kernels A+B": ("rownorm_kernel",),
             "cuDNN gradient convs (dgrad, wgrad)": ("dgrad", "wgrad"),
             "cuDNN/cuBLAS forward convs and matmuls (also those inside the "
             "double backward)": ("fprop", "xmma", "cudnn", "cutlass",
                                  "gemm"),
             "optimizer + EMA (foreach)": ("multi_tensor_apply",),
             "upsample / interpolate": ("upsample_bilinear",)}
    by_part = {k: 0.0 for k in [*parts, "elementwise and reductions",
                                "other"]}
    # less the ranges themselves and the program's spans, which the
    # profiler mirrors on the device's timeline as user annotations
    device_events = [ev for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA
                     and ev.name not in ranges and not ev.is_user_annotation]
    for ev in device_events:
        name = ev.name.lower()
        part = next((k for k, pats in parts.items()
                     if any(pat in name for pat in pats)), None)
        if part is None:
            part = ("elementwise and reductions"
                    if "elementwise" in name or "reduce" in name
                    or "cat" in name or "copy" in name else "other")
        by_part[part] += ev.time_range.elapsed_us() / 1e3 / reps
    total = sum(by_part.values())
    # the labelled ranges as the profiler mirrors them on the device's
    # timeline: from the first to the last kernel launched inside each
    span = {name: sum(ev.time_range.elapsed_us() for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and ev.name == name) / 1e3 / reps for name in ranges}
    require(total > 0 and by_part["kernel C (plain + emit-r)"] > 0
            and by_part["kernel A backward"] > 0
            and by_part["kernel A second order"] > 0,
            "profiler saw no device time for the iteration, kernel C or "
            "kernel A's backward or second derivative")
    by_name = {}
    for ev in device_events:
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / 1e3 / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ms_per_iteration": total, "by_part_ms": by_part,
            "top_kernels_ms": [[n[:90], t] for n, t in top],
            "kernel_a_backward_first_order_ms": span["kernel_a_backward"],
            "kernel_a_second_order_ms": span["kernel_a_second_order"],
            # launches of A+B and of C that the trace holds per iteration:
            # beside the counted launches (A 52 + B 2, C 9 + C emit-r 9)
            # they show whether the trace is whole
            "launches_traced_per_iteration": {
                k: sum(k in ev.name for ev in device_events) / reps
                for k in ("rownorm_kernel", "conv3x3_wgmma_kernel")},
            "note": "the two kernel_a ranges span the device work launched "
                    "inside them: the first order is mostly 'kernel A "
                    "backward', the second order 'kernel A second order' "
                    "and the casts around it"}


@contextlib.contextmanager
def plain_second_order():
    """A's second derivative through its plain closed form (a comparison on
    the card; the port itself has no such switch)."""
    from pgx_torch.ops.kernels import epilogue
    with mock.patch.object(epilogue, "_launch_second_order",
                           epilogue.second_order_ref):
        yield


def train_phase(torch, gcfg, dcfg):
    """The training main path in bf16: launch counts from 0, every metric
    finite, the state moving; then time, memory and the profile."""
    import math
    from pgx_torch.ops import kernels as K
    from pgx_torch.train import make_train_step

    g, d, tc, state = new_train_state(gcfg, dcfg, "bfloat16")
    steps = {fading: make_train_step(g, d, tc, step=TRAIN_STEP,
                                     fading=fading)
             for fading in (False, True)}
    want = calls_per_iteration(g, d, TRAIN_STEP)
    before = {net: [p.detach().clone() for p in state[net].parameters()]
              for net in ("g", "d", "g_ema")}

    # ---- the main path: counts from 0 to what each iteration launched ----
    plan = [(False, 1.0), (True, 0.5), (False, 1.0)]
    launches = {k: 0 for k in want}
    history = []
    for i, (fading, alpha) in enumerate(plan):
        real, labels, z, eps = train_batch(torch, g, seed=300 + i)
        K.reset_launch_counts()
        _, metrics = steps[fading](state, real, labels, alpha, z=z, eps=eps)
        torch.cuda.synchronize()
        got = K.launch_counts()
        require(got == want, f"iteration {i + 1} (fading={fading}): "
                             f"launches {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        vals = {k: float(v) for k, v in metrics.items()}
        require(all(math.isfinite(v) for v in vals.values()),
                f"iteration {i + 1}: metrics {vals}")
        history.append({"fading": fading, "alpha": alpha, **vals})
    # ----------------------------------------------------------------------
    require(state["iteration"] == len(plan)
            and state["opt_d"]["count"] == len(plan)
            and state["opt_g"]["count"] == len(plan),
            f"iteration {state['iteration']} after {len(plan)} steps")
    res = g.resolution(TRAIN_STEP)
    moved = {}
    for net, olds in before.items():
        # parameters on the 128px path; the 64px heads joined in the fade
        deltas = [(p.detach() - o).abs().max().item()
                  for p, o in zip(state[net].parameters(), olds)]
        require(all(math.isfinite(x) for x in deltas), f"{net} not finite")
        moved[net] = sum(x > 0 for x in deltas)
        require(moved[net] > 0, f"{net} did not move")

    # kernel C never from the discriminator: a D forward alone launches A
    # for each of its convs and nothing else
    real, labels, z, eps = train_batch(torch, g, seed=400)
    K.reset_launch_counts()
    with torch.no_grad():
        scores = state["d"](real, labels, step=TRAIN_STEP)
    torch.cuda.synchronize()
    d_alone = K.launch_counts()
    d_convs = (want[A] - 2 * PER_FORWARD[A]) // 4
    require(d_alone == {k: 0 for k in d_alone} | {A: d_convs},
            f"a discriminator forward launched {d_alone}")
    require(scores.shape == (TRAIN_BATCH, 1), f"D output {scores.shape}")

    # ---- time, memory, profile (after the counted run) ----
    def run():
        steps[False](state, real, labels, 1.0, z=z, eps=eps)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, run, reps=7, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    with plain_versions():
        plain_ms = cuda_ms(torch, run, reps=3, warmup=1)
    # the same iteration with A's second derivative in plain ops, as the
    # port ran it before it became a kernel
    with plain_second_order():
        torch.cuda.reset_peak_memory_stats()
        plain2_ms = cuda_ms(torch, run, reps=5, warmup=1)
        plain2_peak = torch.cuda.max_memory_allocated()
    prof = profile_iteration(torch, run)
    return {"resolution": res, "batch": TRAIN_BATCH, "dtype": "bfloat16",
            "iterations_counted": len(plan), "launches": launches,
            "launches_per_iteration": want,
            "discriminator_forward_launches": d_alone,
            "history": history, "tensors_moved": moved,
            "device_ms_per_iteration": ms,
            "plain_path_device_ms_per_iteration": plain_ms,
            "host_wall_ms_per_iteration": host_ms,
            "img_per_s": TRAIN_BATCH / ms * 1e3,
            "peak_memory_bytes": peak,
            "plain_second_order": {"device_ms_per_iteration": plain2_ms,
                                   "peak_memory_bytes": plain2_peak},
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 5: ADA, the ops layer, kernels F, D and E
# ---------------------------------------------------------------------------

ADA_P0 = 0.6              # the controller's p at the start of the ADA run
OPS_SHAPE = (TRAIN_BATCH, 128, 128, 256)     # a flagship 128px activation


def record_launches(torch, run):
    """Every launch of kernels F, D, E and W that ``run()`` makes, forward
    and backward alike, as (kernel, input shape, arguments): recorded where
    the wrappers launch (one kernel launch per call).  F's and W2's input
    may be a view (the y-shear reads the x-shear's column crop, W2 the
    y-shear's row crop): its strides, offset and storage size are recorded
    too.  W1's per-sample parameters are not recorded: the calls that hold
    it draw the pipe's kinds of sample (``warp_case``)."""
    import importlib
    from pgx_torch.ops.kernels import bias_act, shear, upfirdn2d
    warp_resample = importlib.import_module(
        "pgx_torch.ops.kernels.warp_resample")
    calls = []

    def rec(mod, name, describe, attr="_launch"):
        inner = getattr(mod, attr)

        def wrapped(x, *args):
            calls.append((name, tuple(x.shape),
                          json.dumps(describe(x, *args), sort_keys=True)))
            return inner(x, *args)
        return mock.patch.object(mod, attr, wrapped)

    def view(x):
        if x.is_contiguous():
            return {}
        return {"strides": list(x.stride()), "offset": x.storage_offset(),
                "storage": x.untyped_storage().nbytes() // x.element_size()}

    def describe_f(x, shift, axis):
        return {"axis": axis, **view(x)}

    with rec(warp_resample, W1, lambda x, params, vy, vx, taps: {
                "vy": vy, "vx": vx}), \
            rec(warp_resample, W1_T, lambda x, params, n, taps: {"n": n},
                "_launch_t"), \
            rec(warp_resample, W2, lambda x, taps: view(x), "_launch_down"), \
            rec(warp_resample, W2_T, lambda x, taps: {}, "_launch_down_t"), \
            rec(shear, F_, describe_f), \
            rec(upfirdn2d, D_, lambda x, taps, up, down, pads, flip: {
                "taps": list(taps), "up": up, "down": down,
                "pads": list(pads), "flip_filter": flip}), \
            rec(bias_act, E_, lambda x, b, spec, alpha, gain, clamp: {
                "act": next(k for k, v in bias_act.activation_funcs.items()
                            if v is spec),
                "alpha": alpha, "gain": gain, "clamp": clamp,
                "bias": b is not None}):
        run()
        torch.cuda.synchronize()
    return calls


def gather_extent_calls(torch, res: int):
    """Kernel D's launches in the gather warp's resampling at ``res``, batch
    1, as augment_pipe makes them: upsample2d of the reflect-padded image
    (``3*res - 2`` square), downsample2d of the grid-sampled one (``(res +
    2*hz_pad) * 2`` square, ``padding=-2*hz_pad``, flipped), and the
    backward of each."""
    from pgx_torch.augment.pipe import _hz_geom
    from pgx_torch.ops import downsample2d, upsample2d
    hz = _hz_geom()
    hz_pad = hz.shape[0] // 4

    def run():
        side = (res + 2 * hz_pad) * 2
        x = torch.zeros(1, 3 * res - 2, 3 * res - 2, 3, device=DEVICE,
                        requires_grad=True)
        y = torch.zeros(1, side, side, 3, device=DEVICE, requires_grad=True)
        up = upsample2d(x, hz, up=2)
        down = downsample2d(y, hz, down=2, padding=-hz_pad * 2,
                            flip_filter=True)
        torch.autograd.grad((up.sum(), down.sum()), (x, y))

    calls = record_launches(torch, run)
    require(len(calls) == 4, f"gather resampling at {res}px: {calls}")
    return calls


def fde_case(torch, name, shape, opts, dt, rng):
    """Inputs at one recorded launch and what to run there: (kernel, plain
    version, one PyTorch call computing the same function or None, bytes
    moved, operations)."""
    import numpy as np
    from pgx_torch.ops import kernels as K
    es = torch.finfo(dt).bits // 8
    x = (torch.randn(*shape, generator=rng, device=DEVICE)).to(dt)
    numel = x.numel()
    if name in WARP:
        return warp_case(torch, name, shape, opts, dt, rng, x)
    if name == F_:
        axis = opts["axis"]
        b, c, r, n = shape
        if "strides" in opts:
            # the recorded view, on storage of the recorded size
            x = torch.randn(opts["storage"], generator=rng, device=DEVICE).to(
                dt).as_strided(shape, opts["strides"], opts["offset"])
        lines, length = (r, n) if axis == 3 else (n, r)
        # as the warp makes them: one slope per sample, |slope| <= 1, times
        # the centred line coordinate
        slope = torch.rand(b, 1, generator=rng, device=DEVICE) * 2 - 1
        shift = slope * (torch.arange(lines, device=DEVICE)
                         - (lines / 2 - 0.5))
        return (lambda: K.shift_1d(x, shift, axis),
                lambda: K.shift_1d_ref(x, shift, axis), None,
                2 * numel * es + shift.numel() * 4, 3.0 * numel)
    if name == D_:
        taps, up, down = opts["taps"], opts["up"], opts["down"]
        pads, flip = tuple(opts["pads"]), opts["flip_filter"]
        px0, px1, py0, py1 = pads
        b, h, w, c = shape
        n = len(taps)
        oh = K.upfirdn2d.out_len(h, n, up, down, py0, py1)
        ow = K.upfirdn2d.out_len(w, n, up, down, px0, px1)
        ops = 2.0 * (n / up) * b * c * (oh * w + oh * ow)
        nbytes = (numel + b * oh * ow * c) * es
        t = np.asarray(taps, np.float32)
        w2d = torch.from_numpy(np.outer(t, t) if flip else
                               np.outer(t[::-1], t[::-1]).copy()).to(
            device=DEVICE, dtype=dt)[None, None].expand(c, 1, n, n)
        xn = x.permute(0, 3, 1, 2)
        library = None
        # a depthwise convolution is the same function where the padding
        # fits one call's arguments: the gather path's forward calls and
        # the upsample's backward.  The downsample's backward (up 2, pads
        # 12/11 for 12 taps) has none: its output is conv_transpose2d's
        # with a border of zeros, which only a negative padding gives
        if (up, down) == (2, 1) and px1 == px0 - 1 and py1 == py0 - 1 \
                and px0 == py0 <= n - 1:
            w2t = w2d.flip(2, 3)
            library = lambda: torch.nn.functional.conv_transpose2d(
                xn, w2t, stride=2, padding=n - 1 - px0, groups=c)
        elif up == 1 and max(pads) <= 0:
            xc = xn[:, :, -py0:h + py1, -px0:w + px1]
            library = lambda: torch.nn.functional.conv2d(
                xc, w2d, stride=down, groups=c)
        elif up == 1 and px0 == px1 == py0 == py1 > 0:
            # the upsample's backward
            library = lambda: torch.nn.functional.conv2d(
                xn, w2d, stride=down, padding=px0, groups=c)
        return (lambda: K.upfirdn2d_separable(x, taps, up, down, pads, flip),
                lambda: K.upfirdn2d_ref(x, taps, up, down, pads, flip),
                library, nbytes, ops)
    act, clamp = opts["act"], opts["clamp"]
    b = (torch.randn(shape[-1], generator=rng, device=DEVICE) * 0.5
         if opts["bias"] else None)
    return (lambda: K.bias_act_channel_last(x, b, act, opts["alpha"],
                                            opts["gain"], clamp),
            lambda: K.bias_act_ref(x, b, -1, act, opts["alpha"],
                                   opts["gain"], clamp if clamp >= 0
                                   else None),
            None, 2 * numel * es + shape[-1] * es, 10.0 * numel)


WARP = (W1, W1_T, W2, W2_T)


def warp_case(torch, name, shape, opts, dt, rng, x):
    """``fde_case`` for kernel W.  W1 and its transpose take a batch of the
    pipe's kinds of sample: rotations, scales and translations drawn as
    bgc draws them (pivoted to the transposed blit where that is nearer).
    W2's input may be the recorded view.  The plain version runs in f32 on
    the same values: for bf16 inputs it rounds its matrices and its
    intermediate to bf16, the kernel only its output.  Operations: 7 taps
    an axis, two multiply-adds each (x on the staged rows, y per output)."""
    import importlib
    from pgx_torch.augment.pipe import _hz_geom
    from pgx_torch.ops import warp
    wr = importlib.import_module("pgx_torch.ops.kernels.warp_resample")
    hz = tuple(float(v) for v in _hz_geom())
    es = torch.finfo(dt).bits // 8
    numel = x.numel()
    if name in (W2, W2_T):
        if "strides" in opts:
            x = torch.randn(opts["storage"], generator=rng, device=DEVICE).to(
                dt).as_strided(shape, opts["strides"], opts["offset"])
        if name == W2:                  # the crop in, the NHWC side out
            b, c, r, s_ = shape
            big, small = numel, b * (r // 2 - 6) * (s_ // 2 - 6) * c
        else:
            b, h, w, c = shape
            big, small = b * c * (2 * h + 12) * (2 * w + 12), numel
        nbytes = (small + big) * es
        ops = 2.0 * W_TAPS * (big / 2 + small)
        if name == W2:
            return (lambda: wr.warp_down2(x, hz),
                    lambda: wr.warp_down2_ref(x.float(), hz), None, nbytes,
                    ops)
        return (lambda: wr.down_transpose_op(x, hz),
                lambda: wr.warp_down2_t_ref(x.float(), hz), None, nbytes,
                ops)
    b = shape[0]
    th = (torch.rand(b, generator=rng, device=DEVICE) * 2 - 1) * math.pi
    sc = torch.exp2(torch.randn(b, 2, generator=rng, device=DEVICE) * 0.2)
    a = torch.stack([torch.stack([th.cos() * sc[:, 0], -th.sin() * sc[:, 1]],
                                 -1),
                     torch.stack([th.sin() * sc[:, 0], th.cos() * sc[:, 1]],
                                 -1)], 1)
    t = torch.randn(b, 2, generator=rng, device=DEVICE) * 4.0
    params, _, _ = warp.resample_params(a, t)
    if name == W1:
        vy, vx = opts["vy"], opts["vx"]
        out = b * shape[3] * vy * vx
        return (lambda: wr.op(x, params, vy, vx, hz),
                lambda: wr.warp_resample_ref(x.float(), params, vy, vx, hz),
                None, (numel + out) * es, 4.0 * 7 * out)
    n = opts["n"]
    out = b * n * n * shape[1]
    return (lambda: wr.transpose_op(x, params, n, hz),
            lambda: wr.warp_resample_t_ref(x.float(), params, n, hz), None,
            (numel + out) * es, 4.0 * 7 * numel)


W_TAPS = 12               # the pipe's sym6


def warp_512_calls() -> list:
    """Kernel W's four launches at the 512px recipe's shapes, batch 8, as
    the warp makes them (W2 on the y-shear's row crop)."""
    from pgx_torch.ops import warp
    b, n, c = R512_BATCH, 512, 3
    out_n, vy, vx, my2, _ = warp.warp_extents(n, W_TAPS)
    crop = {"strides": [c * vy * out_n, vy * out_n, out_n, 1],
            "offset": my2 * out_n, "storage": b * c * vy * out_n}
    return [(W1, (b, n, n, c), json.dumps({"vx": vx, "vy": vy})),
            (W1_T, (b, c, vy, vx), json.dumps({"n": n})),
            (W2, (b, c, out_n, out_n), json.dumps(crop, sort_keys=True)),
            (W2_T, (b, n, n, c), json.dumps({}))]


def fde_phase(torch, calls, per: str, reps: int = 5, sums=None):
    """Hold kernels F, D, E and W against their plain versions at every
    distinct launch of ``calls``, in bf16 and f32, and time kernel, plain
    version and library call.  Tolerance: both sides compute in f32 and
    round once, so f32 agrees to 1e-5 (sums in another order) and bf16 to
    one bf16 step at the largest output; W, held against its plain version
    in f32 (``warp_case``), to two.  Adds the sums over the calls by
    (kernel, dtype) to ``sums`` and returns it."""
    import math
    rng = torch.Generator(device=DEVICE).manual_seed(7)
    uniq = {}
    for c in calls:
        uniq[c] = uniq.get(c, 0) + 1
    sums = {} if sums is None else sums
    for (name, shape, opts_s), mult in uniq.items():
        HELD.add((name, shape, opts_s))
        opts = json.loads(opts_s)
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            kern, plain, library, nbytes, ops = fde_case(
                torch, name, shape, opts, dt, rng)
            with torch.inference_mode():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref_max = want.float().abs().max().item()
                tol = (bf16_tol(ref_max) / (1 if name in WARP else 2)
                       if dt_name == "bfloat16"
                       else 1e-5 * max(ref_max, 1.0))
                require(got.shape == want.shape and got.dtype == dt,
                        f"{name} {shape} {dt_name}: shape/dtype mismatch")
                require(math.isfinite(err) and err <= tol and ref_max > 0,
                        f"{name} {shape} {opts} {dt_name}: max abs err "
                        f"{err} > tol {tol}")
                lib_ms = None
                if library is not None:
                    lib = library().permute(0, 2, 3, 1)
                    lib_err = (lib.float() - want.float()).abs().max().item()
                    require(lib.shape == want.shape and lib_err <= 4 * tol,
                            f"{name} {shape}: library call differs "
                            f"({lib_err})")
                    del lib
                del got, want
                ms = cuda_ms(torch, kern, reps)
                device_ms = (graph_ms(torch, kern)
                             if name in (D_, F_, *WARP) else None)
                plain_ms = cuda_ms(torch, plain, reps)
                if library is not None:
                    lib_ms = cuda_ms(torch, library, reps)
            t_ops = ops / F32_ELEMENTWISE_OPS * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            small = {k: v for k, v in opts.items() if k not in ("taps", "storage")}
            emit({"phase": "kernel_shape", "kernel": name,
                  "shape": list(shape), "dtype": dt_name, "calls": mult,
                  "per": per, **small, "max_abs_err": err, "tol": tol,
                  "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                  "bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops > t_bytes else "bytes",
                  "library_ms": lib_ms})
            # kernel F is also summed per axis
            keys = [name] + ([f"{name}_axis{opts['axis']}"] if name == F_
                             else [])
            for key in keys:
                agg = sums.setdefault((key, dt_name), {
                    "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                    "t_ops": 0.0, "t_bytes": 0.0, "err": 0.0, "tol": 0.0,
                    "lib_ms": 0.0, "lib_calls": 0, "calls": 0})
                agg["ms"] += mult * ms
                agg["device_ms"] += mult * (device_ms or 0.0)
                agg["plain_ms"] += mult * plain_ms
                agg["t_ops"] += mult * t_ops
                agg["t_bytes"] += mult * t_bytes
                agg["calls"] += mult
                if lib_ms is not None:
                    agg["lib_ms"] += mult * lib_ms
                    agg["lib_calls"] += mult
                if err >= agg["err"]:
                    agg["err"], agg["tol"] = err, tol
    return sums


def fde_gradient_phase(torch):
    """Gradients of F and D (their backward launches the kernel again) and
    of E (plain-op backward, first and second order) against autograd
    through the plain versions, f32, relative to each gradient's largest
    entry: 1e-5 for the linear F and D, 2e-4 for E."""
    import math
    from pgx_torch.ops import kernels as K
    rng = torch.Generator(device=DEVICE).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=rng, device=DEVICE) * scale

    def rel(got, want):
        return max(((a - e).abs().max()
                    / e.abs().max().clamp_min(1e-12)).item()
                   for a, e in zip(got, want))

    def first(fn, x, g):
        leaf = x.clone().requires_grad_(True)
        return torch.autograd.grad((fn(leaf) * g).sum(), leaf)

    out = {}
    img, g = randn(4, 3, 144, 224), randn(4, 3, 144, 224)
    for axis, lines in ((3, 144), (2, 224)):
        shift = randn(4, lines, scale=30.0)
        before = K.launch_counts()[F_]
        got = first(lambda v: K.shift_1d(v, shift, axis), img, g)
        require(K.launch_counts()[F_] == before + 2,
                f"{F_} axis {axis}: the backward did not launch the kernel")
        out[f"{F_}_axis{axis}"] = rel(got, first(
            lambda v: K.shift_1d_ref(v, shift, axis), img, g))
    taps = (torch.rand(12, generator=rng, device=DEVICE) / 3).tolist()
    x = randn(4, 96, 96, 3)
    for up, down, pads, flip in ((2, 1, (6, 5, 6, 5), False),
                                 (1, 2, (-1, -1, -1, -1), True)):
        fn = lambda v: K.upfirdn2d_separable(v, taps, up, down, pads, flip)
        gy = torch.randn_like(fn(x))
        before = K.launch_counts()[D_]
        got = first(fn, x, gy)
        require(K.launch_counts()[D_] == before + 2,
                f"{D_} up={up} down={down}: the backward did not launch "
                f"the kernel")
        out[f"{D_}_up{up}_down{down}"] = rel(got, first(
            lambda v: K.upfirdn2d_ref(v, taps, up, down, pads, flip), x, gy))
    for name, err in out.items():
        require(math.isfinite(err) and err <= 1e-5,
                f"{name}: gradient max rel err {err} > 1e-5")

    x, b, g = randn(8, 16, 16, 256), randn(256, scale=0.5), randn(
        8, 16, 16, 256)

    def both_orders(fn):
        tx, tb = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        one = torch.autograd.grad((fn(tx, tb) * g).sum(), (tx, tb),
                                  create_graph=True)
        pen = (one[0].square() * (1.0 + g)).sum()
        return [*one, *torch.autograd.grad(pen, (tx, tb))]

    for act in ("tanh", "swish", "softplus", "selu"):
        got = both_orders(lambda x_, b_: K.bias_act_channel_last(
            x_, b_, act, 0.0, 1.3, 1.5))
        want = both_orders(lambda x_, b_: K.bias_act_ref(
            x_, b_, -1, act, 0.0, 1.3, 1.5))
        for order, sl in (("first", slice(0, 2)), ("second", slice(2, 4))):
            err = rel(got[sl], want[sl])
            require(math.isfinite(err) and err <= 2e-4,
                    f"{E_} {act}: {order}-order gradient max rel err {err}")
            out[f"{E_}_{act}_{order}_order"] = err
    torch.cuda.synchronize()
    return {"max_rel_err": out, "tol": {F_: 1e-5, D_: 1e-5, E_: 2e-4}}


def ops_layer_phase(torch):
    """The ops layer through its public functions, at a flagship-sized
    activation: conv2d_resample with a separable filter (upsample by 2,
    kernel D, then a 3x3 conv) followed by bias_act (kernel E).  Launch
    counts from 0; the result against the same calls with the plain
    versions swapped in."""
    from pgx_torch.ops import (bias_act, conv2d_resample, kernels as K,
                               setup_filter)
    rng = torch.Generator(device=DEVICE).manual_seed(13)
    b, h, w, c = OPS_SHAPE
    x = torch.randn(b, h // 2, w // 2, 64, generator=rng,
                    device=DEVICE).to(torch.bfloat16)
    wt = torch.randn(3, 3, 64, c, generator=rng, device=DEVICE) * (
        2.0 / (9 * 64)) ** 0.5
    bias = torch.randn(c, generator=rng, device=DEVICE) * 0.1
    f = setup_filter([1, 3, 3, 1], separable=True)

    def block():
        y = conv2d_resample(x, wt, f, up=2, padding=1)
        return bias_act(y, bias, act="lrelu", clamp=256.0)

    # ---- the ops layer's path: counts from 0 to what it launched ----
    K.reset_launch_counts()
    with torch.inference_mode():
        got = block()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # -----------------------------------------------------------------
    want_counts = {k: 0 for k in launches}
    want_counts.update({D_: 1, E_: 1})
    require(launches == want_counts, f"ops layer launched {launches}")
    with plain_versions(), torch.inference_mode():
        want = block()
    torch.cuda.synchronize()
    require(got.shape == OPS_SHAPE and got.dtype == torch.bfloat16
            and bool(torch.isfinite(got.float()).all()),
            f"ops layer output {got.shape} {got.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * bf16_tol(want.float().abs().max().item())
    require(err <= tol, f"ops layer vs plain versions: {err} > {tol}")
    with torch.inference_mode():
        ms = cuda_ms(torch, block, reps=5)
    calls = record_launches(torch, lambda: block())
    return {"shape": list(OPS_SHAPE), "launches": launches,
            "max_abs_err": err, "tol": tol, "block_ms": ms}, calls


def shear_pipe_f32_check(torch, res: int):
    """The shear pipe through kernels W and F against the same pipe with the
    plain versions swapped in, f32, the same seeded draws, with its
    gradient.  Tolerance 1e-4 of the largest output: the blend's
    multiply-add contracts differently, and sums downstream reorder."""
    from pgx_torch.augment import TorchDraws, augment_pipe, bgc_config
    rng = torch.Generator(device=DEVICE).manual_seed(17)
    x = torch.randn(8, res, res, 3, generator=rng,
                    device=DEVICE).clamp_(-1.0, 1.0)
    g = torch.randn(8, res, res, 3, generator=rng, device=DEVICE)

    def run():
        leaf = x.clone().requires_grad_(True)
        draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(19))
        out = augment_pipe(draws, leaf, bgc_config(), 0.9)
        return out.detach(), torch.autograd.grad((out * g).sum(), leaf)[0]

    out_k, grad_k = run()
    with plain_versions():
        out_p, grad_p = run()
    torch.cuda.synchronize()
    report = {}
    for what, a, e in (("output", out_k, out_p), ("gradient", grad_k,
                                                  grad_p)):
        scale = e.abs().max().item()
        err = (a - e).abs().max().item()
        require(scale > 0 and err <= 1e-4 * scale,
                f"shear pipe {what}, kernels vs plain: {err} at {scale}")
        report[what] = {"max_abs_err": err, "ref_max_abs": scale}
    require((out_k - x).abs().max().item() > 1e-2, "the pipe did nothing")
    return report


def new_ada_step(gcfg, dcfg, warp: str):
    """A bf16 flagship state with the controller at ``ADA_P0`` and its ADA
    train step (bgc policy, adaptive controller)."""
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.train import make_train_step
    g, d, tc, state = new_train_state(gcfg, dcfg, "bfloat16")
    # as a resumed run sets it: the constructor's default device is the card
    state["ada"] = init_ada_state(ADA_P0, DEVICE)
    require(all(v.device.type == DEVICE for v in state["ada"].values()),
            "init_ada_state() did not land on the card")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                           augment_cfg=bgc_config(warp_impl=warp),
                           ada_cfg=AdaConfig())
    return g, d, state, step


def ada_batch(torch, gcfg, seed: int):
    from pgx_torch.train import draw_augment_sources
    real, labels, z, eps = train_batch(torch, gcfg, seed)
    rng = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    return real, labels, dict(z=z, eps=eps,
                              aug_draws=draw_augment_sources(rng))


def record_ada_launches(torch, gcfg, dcfg, warp: str):
    """The launches of F, D, E and W in one bf16 ADA iteration, batch
    32."""
    g, d, state, step = new_ada_step(gcfg, dcfg, warp)
    real, labels, draws = ada_batch(torch, g, seed=500)
    calls = record_launches(
        torch, lambda: step(state, real, labels, 1.0, **draws))
    want = calls_per_iteration(g, d, TRAIN_STEP, warp)
    got = count_calls(calls)
    require(got == {k: want[k] for k in (F_, D_, *WARP) if want[k]},
            f"{warp} ADA iteration recorded {got}")
    return calls


def profile_ada_iteration(torch, run, reps: int = 2):
    """Device time of one bf16 ADA iteration by part (torch.profiler,
    kernels classified by name), with the forward calls of the pipe as a
    labelled range (its backward runs inside autograd's and is not in the
    range; kernel F's launches are counted by name in both).  Also what
    kernel W took off the path: float32 matrix products (CUTLASS's SIMT
    "sgemm" and cuBLAS's "gemm_f32f32" kernels; the color stage's 3 x 3
    products per pixel and the pipe's 4 x 4 matrices remain) and copies
    from pageable host memory, of which the pipe's ranges must hold
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from pgx_torch.train import wgan
    inner = wgan.augment_pipe

    def labelled(*args, **kw):
        with record_function("augment_pipe_forward"):
            return inner(*args, **kw)

    with mock.patch.object(wgan, "augment_pipe", labelled):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    parts = {"kernel F": ("shear_cols", "shear_rows"),
             "kernel W": ("resample_kernel", "resample_t_kernel",
                          "down2_kernel", "down2_t_kernel"),
             "kernel C (plain + emit-r)": ("conv3x3_wgmma_kernel",
                                           "conv3x3_fma_kernel"),
             "kernel A second order": ("rownorm_bwd2",),
             "kernel A backward": ("rownorm_bwd",),
             "kernels A+B": ("rownorm_kernel",),
             "cuDNN gradient convs (dgrad, wgrad)": ("dgrad", "wgrad"),
             "cuDNN/cuBLAS forward convs and matmuls (also the pipe's "
             "einsums)": ("fprop", "xmma", "cudnn", "cutlass", "gemm"),
             "optimizer + EMA (foreach)": ("multi_tensor_apply",),
             "upsample / interpolate": ("upsample_bilinear",)}
    by_part = {k: 0.0 for k in [*parts, "elementwise, reductions, copies",
                                "other"]}
    pipe_ms = 0.0
    pipe_ranges = [(ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and ev.name == "augment_pipe_forward"]
    pipe_kernels, pipe_busy_ms = 0, 0.0
    f32_gemm, pageable = {}, {"iteration": 0, "pipe": 0}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3 / reps
        if ev.name == "augment_pipe_forward":
            pipe_ms += ms
            continue
        if ev.is_user_annotation:       # the program's spans
            continue
        in_pipe = any(lo <= ev.time_range.start <= hi
                      for lo, hi in pipe_ranges)
        if in_pipe:
            pipe_kernels += 1
            pipe_busy_ms += ms
        name = ev.name.lower()
        if "sgemm" in name or "gemm_f32f32" in name:
            f32_gemm[ev.name[:96]] = f32_gemm.get(ev.name[:96], 0.0) + ms
        if "pageable" in name and "htod" in name.replace(" ", ""):
            pageable["iteration"] += 1
            pageable["pipe"] += in_pipe
        part = next((k for k, pats in parts.items()
                     if any(pat in name for pat in pats)), None)
        if part is None:
            part = ("elementwise, reductions, copies"
                    if any(w in name for w in ("elementwise", "reduce",
                                               "cat", "copy", "index",
                                               "gather", "pad"))
                    else "other")
        by_part[part] += ms
    total = sum(by_part.values())
    require(total > 0 and by_part["kernel F"] > 0 and by_part["kernel W"] > 0
            and pipe_ms > 0 and pipe_kernels > 0,
            "profiler saw no device time for kernel F, W or the pipe")
    require(pageable["pipe"] == 0,
            f"the pipe copied from pageable host memory: {pageable}")
    return {"device_ms_per_iteration": total, "by_part_ms": by_part,
            "f32_gemm_ms_by_kernel": f32_gemm,
            "f32_gemm_ms": sum(f32_gemm.values()),
            "pageable_htod_copies": {k: v / reps for k, v in
                                     pageable.items()},
            "augment_pipe_forward_3_calls_ms": pipe_ms,
            "augment_pipe_forward_3_calls_busy_ms": pipe_busy_ms,
            "augment_pipe_forward_kernels_per_call":
                pipe_kernels / max(len(pipe_ranges), 1),
            "note": "augment_pipe_forward_3_calls_ms spans the three "
                    "forward calls of the pipe on the device's timeline, "
                    "..._busy_ms is the time of the device kernels and "
                    "copies that start inside those spans, "
                    "..._kernels_per_call their number per call; the "
                    "pipe's kernels are also counted in by_part_ms"}


def ada_train_phase(torch, gcfg, dcfg):
    """The slice's main path: bf16 ADA iterations of the flagship at 128px,
    batch 32, shear warp, launch counts from 0 per iteration; then one
    iteration with the gather warp; then time, memory and the profile."""
    import math
    from pgx_torch.augment import (AdaConfig, TorchDraws, augment_pipe,
                                   bgc_config)
    from pgx_torch.ops import kernels as K

    g, d, state, step = new_ada_step(gcfg, dcfg, "shear")
    want = calls_per_iteration(g, d, TRAIN_STEP, "shear")
    acfg = AdaConfig()
    before = [p.detach().clone() for p in state["g"].parameters()]

    # ---- the main path: counts from 0 to what each iteration launched ----
    launches = {k: 0 for k in want}
    history = []
    sign_sum, p_now = 0.0, ADA_P0
    for i in range(acfg.interval_batches + 1):
        real, labels, draws = ada_batch(torch, g, seed=600 + 2 * i)
        K.reset_launch_counts()
        _, metrics = step(state, real, labels, 1.0, **draws)
        torch.cuda.synchronize()
        got = K.launch_counts()
        require(got == want, f"ADA iteration {i + 1}: launches {got} != "
                             f"{want}")
        for k in launches:
            launches[k] += got[k]
        vals = {k: float(v) for k, v in metrics.items()}
        require(all(math.isfinite(v) for v in vals.values()),
                f"ADA iteration {i + 1}: metrics {vals}")
        # the controller, replayed on the host from the logged r_t
        sign_sum += vals["ada_r"] * TRAIN_BATCH
        count = TRAIN_BATCH * ((i % acfg.interval_batches) + 1)
        if count > TRAIN_BATCH * acfg.interval_batches - 1:
            direction = 1.0 if sign_sum / count > acfg.ada_target else -1.0
            p_now = min(max(p_now + direction * TRAIN_BATCH
                            / acfg.ada_length * count, 0.0), 1.0)
            sign_sum, count = 0.0, 0
        ada = {k: float(v) for k, v in state["ada"].items()}
        require(abs(ada["p"] - p_now) <= 1e-6 and ada["count"] == count
                and abs(ada["sign_sum"] - sign_sum) <= 1e-3
                and abs(vals["ada_p"] - p_now) <= 1e-6,
                f"ADA iteration {i + 1}: controller {ada}, metric "
                f"{vals['ada_p']}, expected p {p_now}, count {count}, "
                f"sign_sum {sign_sum}")
        history.append({**vals, "ada_state": ada})
    # ----------------------------------------------------------------------
    require(p_now != ADA_P0, "the controller never updated p")
    moved = sum((p.detach() - o).abs().max().item() > 0
                for p, o in zip(state["g"].parameters(), before))
    require(moved > 0, "the generator did not move under ADA")

    # ---- one iteration with the gather warp: kernel D, counts from 0 ----
    g2, d2, state2, step2 = new_ada_step(gcfg, dcfg, "gather")
    want2 = calls_per_iteration(g2, d2, TRAIN_STEP, "gather")
    real, labels, draws = ada_batch(torch, g2, seed=700)
    K.reset_launch_counts()
    _, metrics2 = step2(state2, real, labels, 1.0, **draws)
    torch.cuda.synchronize()
    got2 = K.launch_counts()
    require(got2 == want2, f"gather ADA iteration: launches {got2} != "
                           f"{want2}")
    vals2 = {k: float(v) for k, v in metrics2.items()}
    require(all(math.isfinite(v) for v in vals2.values()),
            f"gather ADA iteration: metrics {vals2}")
    gather_ms = cuda_ms(
        torch, lambda: step2(state2, real, labels, 1.0, **draws), reps=3,
        warmup=0)
    del state2, step2

    # ---- time, memory, profile (after the counted runs) ----
    real, labels, draws = ada_batch(torch, g, seed=800)

    def run():
        step(state, real, labels, 1.0, **draws)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, run, reps=7, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    with plain_versions():
        plain_ms = cuda_ms(torch, run, reps=3, warmup=1)
    with plain_second_order():
        plain2_ms = cuda_ms(torch, run, reps=5, warmup=1)

    # the pipe alone at the iteration's shapes, forward and with backward
    fake = torch.randn(TRAIN_BATCH, 128, 128, 3, device=DEVICE).clamp_(
        -1, 1).to(torch.bfloat16)
    pipe_draws = TorchDraws(torch.Generator(device=DEVICE).manual_seed(23))

    def pipe_forward():
        with torch.no_grad():
            augment_pipe(pipe_draws, fake, bgc_config(), 0.6)

    def pipe_both():
        leaf = fake.clone().requires_grad_(True)
        augment_pipe(pipe_draws, leaf, bgc_config(), 0.6).sum().backward()

    pipe_fwd_ms = cuda_ms(torch, pipe_forward, reps=5)
    pipe_both_ms = cuda_ms(torch, pipe_both, reps=5)
    prof = profile_ada_iteration(torch, run)
    return {"resolution": 128, "batch": TRAIN_BATCH, "dtype": "bfloat16",
            "augment": "bgc_config(), AdaConfig(), warp_impl='shear', "
                       f"p from {ADA_P0}",
            "iterations_counted": len(history), "launches": launches,
            "launches_per_iteration": want, "history": history,
            "generator_tensors_moved": moved,
            "gather_iteration": {"launches": got2, "metrics": vals2,
                                 "device_ms_per_iteration": gather_ms},
            "device_ms_per_iteration": ms,
            "plain_path_device_ms_per_iteration": plain_ms,
            "host_wall_ms_per_iteration": host_ms,
            "img_per_s": TRAIN_BATCH / ms * 1e3,
            "peak_memory_bytes": peak,
            "plain_second_order_device_ms_per_iteration": plain2_ms,
            "pipe_alone_b32_bf16": {"forward_ms": pipe_fwd_ms,
                                    "forward_backward_ms": pipe_both_ms},
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 6: the training loop through the flagship's CLI
# ---------------------------------------------------------------------------

LOOP_ARGS = ["--synthetic", "--channels", "512", "--z-dim", "512",
             "--num-classes", "10", "--max-step", "6", "--init-step", "5",
             "--dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH),
             "--images-per-mini-step", "96", "--ada-p", "0.6",
             "--sample-every", "3", "--checkpoint-every", "3",
             "--log-every", "3"]
LOOP_TOTAL = 12          # 3 iterations a mini-step: 64px fade + stable,
LOOP_CADENCE = (1, 3, 6, 9, 12)   # 128px fade + stable; events every 3
# the in-process run also scores FID: at 6 (64px) and 12 (128px)
LOOP_FID_SAMPLES = 256
LOOP_FID_ARGS = ["--fid-every", "6", "--fid-samples", str(LOOP_FID_SAMPLES)]
LOOP_FID_TICKS = {6: 64, 12: 128}


@contextlib.contextmanager
def loop_probes(torch):
    """Measurement around the loop (none of it changes what the loop does):
    every checkpoint write timed after a synchronize, with the bytes of the
    files it wrote; every sample grid's PNG encode and write (its images
    are on the host by then); every prefetcher the loop opens, for its wait
    time; the first step of the run timed to its end and the iteration it
    starts from."""
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.train import loop as loop_mod
    orig_save, orig_step = ckpt.save_checkpoint, loop_mod.make_train_step
    orig_grid = loop_mod.save_image_grid
    from pgx_torch.eval.sweep import TrainingFid
    orig_fid = TrainingFid.score
    probes = {"writes": [], "grids_s": [], "prefetchers": [],
              "first_step": None, "fid_ticks": []}

    def timed_fid(self, trial_dir, iteration, generator, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fid = orig_fid(self, trial_dir, iteration, generator, st)
        probes["fid_ticks"].append({"iteration": iteration, "fid": fid,
                                    "resolution": st.resolution,
                                    "seconds": time.perf_counter() - t0})
        return fid

    def timed_grid(*a, **kw):
        t0 = time.perf_counter()
        orig_grid(*a, **kw)
        probes["grids_s"].append(time.perf_counter() - t0)

    def timed_save(trial_dir, iteration, state, full_state=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_save(trial_dir, iteration, state, full_state)
        dt = time.perf_counter() - t0
        names = [ckpt.checkpoint_name(iteration, k) for k in ("g", "d")]
        if full_state:
            names.append(ckpt.state_name(iteration))
        probes["writes"].append({
            "iteration": iteration, "seconds": dt, "full_state": full_state,
            "bytes": sum(os.path.getsize(os.path.join(
                trial_dir, "checkpoint", n)) for n in names)})

    class Prefetcher(loop_mod.DevicePrefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            probes["prefetchers"].append(self)

    def first_step_timed(*a, **kw):
        step = orig_step(*a, **kw)

        def run(state, *sa, **skw):
            if probes["first_step"] is not None:
                return step(state, *sa, **skw)
            start_iter = state["iteration"]
            t0 = time.perf_counter()
            out = step(state, *sa, **skw)
            torch.cuda.synchronize()
            probes["first_step"] = {"iteration": start_iter,
                                    "ended_s": time.perf_counter(),
                                    "step_s": time.perf_counter() - t0}
            return out
        return run

    with mock.patch.object(ckpt, "save_checkpoint", timed_save), \
            mock.patch.object(loop_mod, "DevicePrefetcher", Prefetcher), \
            mock.patch.object(loop_mod, "make_train_step", first_step_timed), \
            mock.patch.object(loop_mod, "save_image_grid", timed_grid), \
            mock.patch.object(TrainingFid, "score", timed_fid):
        yield probes


def check_trial(trial: str) -> dict:
    """What the run must have left: finite losses in every CSV row, 64px
    then 128px in timing.json, the sample grids (10 x 10 tiles) and the
    checkpoint files at the cadence."""
    import math
    import glob
    (log,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
    with open(log) as f:
        lines = f.read().splitlines()
    require(lines[0] == "iter,g,d,grad,alpha,ada_p,ada_r",
            f"CSV header {lines[0]!r}")
    rows = [[float(v) for v in line.split(",")] for line in lines[1:]]
    require([int(r[0]) for r in rows] == [3, 6, 9, 12],
            f"CSV iterations {[r[0] for r in rows]}")
    require(all(math.isfinite(v) for r in rows for v in r),
            f"CSV rows {rows}")
    with open(os.path.join(trial, "timing.json")) as f:
        timing = json.load(f)
    require({k: v["resolution"] for k, v in timing.items()}
            == {"3": 64, "6": 64, "9": 128, "12": 128},
            f"timing.json {timing}")
    names = set(os.listdir(os.path.join(trial, "checkpoint")))
    samples = sorted(os.listdir(os.path.join(trial, "sample")))
    for it in LOOP_CADENCE:
        for kind in ("g.model", "d.model", "state.pt"):
            require(f"{it:03d}_{kind}" in names,
                    f"no {it:03d}_{kind} in {sorted(names)}")
        require(f"{it:03d}.png" in samples, f"no sample {it}: {samples}")
    grids = {}
    for name in samples:
        with open(os.path.join(trial, "sample", name), "rb") as f:
            head = f.read(24)
        w, h = (int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big"))
        res = 64 if int(name[:3]) <= 6 else 128
        require(head[:8] == b"\x89PNG\r\n\x1a\n"
                and w == h == 10 * (res + 2) + 2,
                f"sample {name}: {w}x{h}, want 10 x 10 tiles of {res}px")
        grids[name] = [w, h]
    return {"csv": rows, "timing": timing, "sample_grids": grids}


def check_loop_fid(trial: str, ticks: list) -> dict:
    """The in-training FID's entries: finite scores at the cadence in
    fid_score.json, each marked in-training, each printed value's."""
    import math
    with open(os.path.join(trial, "fid_score.json")) as f:
        scores = json.load(f)
    with open(os.path.join(trial, "fid_score_meta.json")) as f:
        meta = json.load(f)
    names = {f"{it:03d}_g.model" for it in LOOP_FID_TICKS}
    require(set(scores) == names and all(math.isfinite(v)
                                         for v in scores.values()),
            f"fid_score.json {scores}")
    require(meta == {n: "in-training" for n in names},
            f"fid_score_meta.json {meta}")
    require({t["iteration"]: t["resolution"] for t in ticks}
            == LOOP_FID_TICKS and all(scores[f"{t['iteration']:03d}_g.model"]
                                      == t["fid"] for t in ticks),
            f"FID ticks {ticks} against {scores}")
    return scores


def train_loop_phase(torch, bare: dict):
    """The flagship's training CLI in this process at full width, bf16,
    batch 32, 64px -> 128px with the shear warp at p = 0.6: launch counts
    from 0 around it, the trial it leaves checked.  Then the same CLI in a
    child process, sent SIGTERM once its first checkpoint is on disk, must
    exit 143 with an emergency checkpoint, and ``--resume`` here finishes
    its run from that iteration."""
    import glob
    import shutil
    from pgx_torch import native
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    from pgx_torch.ops import kernels as K

    # the data path's C++ runtime, built from the checkout's source here
    t_native = time.perf_counter()
    require(native.native_available(), f"the C++ host runtime did not "
                                       f"build: {native.unavailable_reason}")
    native_report = {"available": True,
                     "build_s": native.build_seconds,
                     "load_s": time.perf_counter() - t_native,
                     "library": os.path.relpath(
                         native.library_path(), os.path.dirname(
                             os.path.abspath(__file__)))}
    here = os.path.dirname(os.path.abspath(__file__))
    from scipy.linalg import LinAlgWarning
    root = tempfile.mkdtemp(prefix="pgx_train_loop_")
    try:
        args = LOOP_ARGS + LOOP_FID_ARGS + ["--output",
                                            os.path.join(root, "run")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with loop_probes(torch) as probes, \
                warnings.catch_warnings(record=True) as caught:
            # the loop turns a failed FID tick into a RuntimeWarning and
            # trains on: here any RuntimeWarning fails the phase.  scipy's
            # LinAlgWarning (a RuntimeWarning) reports a numerically
            # singular covariance product, which the Frechet distance's own
            # fallback handles; it is recorded and counted
            warnings.simplefilter("error", RuntimeWarning)
            warnings.simplefilter("always", LinAlgWarning)
            # ---- the main path: counts from 0 around the CLI run ----
            K.reset_launch_counts()
            t0 = time.perf_counter()
            trial = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            # ----------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        run = check_trial(trial)
        fid_scores = check_loop_fid(trial, probes["fid_ticks"])
        linalg_warnings = sum(issubclass(w.category, LinAlgWarning)
                              for w in caught)
        full = [w for w in probes["writes"] if w["full_state"]]
        require(len(full) == len(LOOP_CADENCE) + 1,
                f"checkpoint writes {probes['writes']}")
        waits = [p.wait_s for p in probes["prefetchers"]]
        require(len(waits) == 2, f"{len(waits)} prefetchers (want one per "
                                 f"resolution)")
        tick = run["timing"][str(LOOP_TOTAL)]

        # ---- SIGTERM to the CLI in its own process, then --resume ----
        torch.cuda.empty_cache()
        out_dir = os.path.join(root, "stopped")
        child = subprocess.Popen(
            [sys.executable, "-m",
             "pgx_torch.cli.conditional_proper_cifar_train",
             *LOOP_ARGS, "--output", out_dir], cwd=here,
            env={**os.environ, "PYTHONPATH": here}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 300
            while (time.monotonic() < deadline and child.poll() is None
                   and not glob.glob(os.path.join(
                       out_dir, "trial_*", "checkpoint", "001_state.pt"))):
                time.sleep(0.02)
            t_sig = time.perf_counter()
            child.send_signal(signal.SIGTERM)
            out, _ = child.communicate(timeout=300)
            stop_s = time.perf_counter() - t_sig
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        require(child.returncode == 143,
                f"the CLI exited {child.returncode} on SIGTERM:\n{out[-3000:]}")
        (stopped_trial,) = glob.glob(os.path.join(out_dir, "trial_*"))
        states = sorted(glob.glob(os.path.join(
            stopped_trial, "checkpoint", "*_state.pt")))
        stopped_at = int(os.path.basename(states[-1]).split("_")[0])
        require(f"emergency checkpoint saved at iteration {stopped_at}"
                in out and 1 <= stopped_at < LOOP_TOTAL,
                f"no emergency checkpoint at {stopped_at}:\n{out[-3000:]}")
        with loop_probes(torch) as resume_probes:
            t_resume = time.perf_counter()
            cli.main(LOOP_ARGS + ["--output", out_dir, "--resume",
                                  stopped_trial])
            resume_wall = time.perf_counter() - t_resume
        first = resume_probes["first_step"]
        require(first["iteration"] == stopped_at,
                f"resumed at {first['iteration']}, the emergency checkpoint "
                f"is at {stopped_at}")
        resumed = check_trial(stopped_trial)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not os.path.exists(root), f"{root} left behind")
    windows = {it: run["timing"][str(it)]["elapsed_s"]
               - run["timing"][str(it - 3)]["elapsed_s"] for it in (9, 12)}
    return {
        "config": "python -m pgx_torch.cli.conditional_proper_cifar_train "
                  + " ".join(LOOP_ARGS + LOOP_FID_ARGS),
        "iterations": LOOP_TOTAL, "launches": launches,
        "fid": {"scores": fid_scores, "ticks": probes["fid_ticks"],
                "linalg_warnings": linalg_warnings,
                # the log windows of 3 iterations at 128px (timing.json):
                # the one ending at 12 holds the 128px tick
                "window_s_9": windows[9], "window_s_12": windows[12]},
        "wall_s": wall, "peak_memory_bytes": peak,
        "img_per_s_128px_stable_timing_json": tick["img_s"],
        "bare_step_img_per_s": {"train": bare["train"],
                                "train_ada": bare["train_ada"]},
        "prefetch_wait_s": {"total": sum(waits), "per_resolution": waits},
        "native_runtime": native_report,
        "checkpoint_writes": probes["writes"],
        "full_checkpoint_s_mean": statistics.mean(
            w["seconds"] for w in full),
        "full_checkpoint_bytes": full[0]["bytes"],
        "sample_grid_png_s": probes["grids_s"],
        "sigterm": {"stopped_at_iteration": stopped_at,
                    "exit_code": child.returncode,
                    "seconds_from_signal_to_exit": stop_s},
        "resume": {"first_iteration": first["iteration"],
                   "first_iteration_s": first["ended_s"] - t_resume,
                   "first_step_s": first["step_s"],
                   "wall_s": resume_wall,
                   "csv_rows": resumed["csv"]},
        "csv": run["csv"], "timing": run["timing"],
        "sample_grids": run["sample_grids"]}


# ---------------------------------------------------------------------------
# phase 7: the remaining entry points of pgx_torch.cli
# ---------------------------------------------------------------------------

CLI_GROW_ARGS = ["--target-channels", "512,512,512,512,256,128,64,32",
                 "--target-max-step", "8", "--check-step", "6"]
CLI_PER_CLASS = 10        # generate: 10 classes x 10 at batch 50, 2 batches
# profile_step: (its flags, the step, the penalty mode of its TrainConfig);
# 10 traced steps, then 10 timed ones, each step's time read
CLI_PROFILE_RUNS = ((["--step", "6", "--steps", "10"], 6, "reverse"),
                    (["--step", "8", "--gp-mode", "jvp", "--batch-size", "8",
                      "--steps", "10"], 8, "jvp"))
# the same configs once more, one traced and one timed step, with every
# launch recorded (the timed run above carries no recording wrappers)
CLI_PROFILE_RECORDED = ["--steps", "1"]
CLI_AUG_ROWS = 5
CLI_AUG_ARGS = ["--synthetic", "--rows", str(CLI_AUG_ROWS), "--size", "128"]
# every trainer at its default widths, 4-6 iterations over two stages, the
# CSV every iteration, samples every 2 iterations; (flags, iterations)
CLI_TRAINERS = {
    "train": (["--total-iter", "6", "--init-step", "2"], 6),
    "mnist_train": (["--total-iter", "6", "--init-step", "2"], 6),
    "cifar_train": (["--total-iter", "6", "--init-step", "2"], 6),
    "proper_cifar_train": (["--images-per-mini-step", "4", "--init-step",
                            "3"], 4),
    "conditional_cifar10_wgan_train": (["--total-iter", "6", "--init-step",
                                        "2"], 6),
    "conditional_mnist_wgan_train": (["--total-iter", "6", "--init-step",
                                      "2"], 6),
    "conditional_proper_wikiart": (["--images-per-mini-step", "4",
                                    "--init-step", "5"], 4),
}
CLI_SAMPLE_EVERY = 2
CLI_TRAIN_ARGS = ["--synthetic", "--log-every", "1", "--sample-every",
                  str(CLI_SAMPLE_EVERY), "--checkpoint-every", "1000"]
CLI_GIF_TRIAL = "cifar_train"     # a 5 x 10 grid, create_gif's default
CLI_HOLD_REPS = 3         # timing repetitions where the cli phase holds


def counted_run(torch, fn):
    """One main path: ``fn()`` with launch counts from 0 around it; its
    result, the counts and its seconds."""
    from pgx_torch.ops import kernels as K
    # ---- the main path: counts from 0 around it ----
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    # -------------------------------------------------
    return out, launches, seconds


def recorded_run(torch, fn):
    """``counted_run`` with every launch recorded where it is made: A, B,
    C, C emit-r and A's backward (``record_calls``), A's second derivative
    (``recording_second``), A's tangent as (shape, db given), F, D and E
    (``record_launches``).  The records must account for every launch the
    counts show.  Returns the result, the launches, the seconds and the
    four lists of calls."""
    from pgx_torch.ops.kernels import epilogue
    box, second, tangent = {}, [], []
    inner_jvp = epilogue._launch_jvp

    def rec_jvp(y, b, dy, db, slope, eps):
        tangent.append((tuple(y.shape), db is not None))
        return inner_jvp(y, b, dy, db, slope, eps)

    def run():
        box["out"] = fn()

    def recorded():
        with recording_second(second), mock.patch.object(
                epilogue, "_launch_jvp", rec_jvp):
            box["calls"] = record_calls(torch, lambda: box.__setitem__(
                "fde", record_launches(torch, run)))

    _, launches, seconds = counted_run(torch, recorded)
    got = {**count_calls(box["calls"]), **count_calls(box["fde"]),
           A_BWD2: len(second), A_JVP: len(tangent)}
    rec = {k: got.get(k, 0) for k in launches}
    require(rec == launches, f"recorded calls {rec} != launches {launches}")
    return (box["out"], launches, seconds,
            (box["calls"], second, tangent, box["fde"]))


def hold(torch, per: str, recorded) -> dict:
    """Hold every recorded call that no phase of this run has held yet
    against its plain version, in bf16 and f32 at the standing tolerances
    (``kernel_phase``, ``second_order_phase``, ``tangent_kernel_phase``,
    ``fde_phase``; each fails the run on a disagreement).  Per kernel: its
    distinct calls, how many of them an earlier phase held, and the
    largest error held here with its tolerance, by dtype."""
    calls, second, tangent, fde = recorded
    keyed = ({(c[0], c) for c in calls + fde}
             | {(A_BWD2, (A_BWD2, *c)) for c in second}
             | {(A_JVP, (A_JVP, *c)) for c in tangent})
    out = {}
    for name, key in sorted(keyed, key=repr):
        row = out.setdefault(name, {"distinct_calls": 0, "held_earlier": 0})
        row["distinct_calls"] += 1
        row["held_earlier"] += key in HELD
    new = [c for c in calls if c not in HELD]
    new_second = [c for c in second if (A_BWD2, *c) not in HELD]
    new_tangent = [c for c in tangent if (A_JVP, *c) not in HELD]
    new_fde = [c for c in fde if c not in HELD]
    sums = kernel_phase(torch, new, per, reps=CLI_HOLD_REPS) if new else {}
    if new_fde:
        fde_phase(torch, new_fde, per, reps=CLI_HOLD_REPS, sums=sums)
    for (name, dt), agg in sums.items():
        if name in out:           # F's per-axis sums are in F's
            out[name][dt] = {"max_abs_err": agg["err"], "tol": agg["tol"]}
    if new_second:
        so = second_order_phase(torch, new_second, reps=CLI_HOLD_REPS)
        out[A_BWD2]["bfloat16"] = {"max_abs_err": so["max_abs_err"],
                                   "tol": so["tol"]}
        out[A_BWD2]["float32"] = {"max_rel_err": so["f32"]["max_rel_err"],
                                  "rel_tol": 1e-5}
    if new_tangent:
        tg = tangent_kernel_phase(torch, new_tangent, reps=CLI_HOLD_REPS)
        out[A_JVP]["bfloat16"] = {"max_abs_err": tg["max_abs_err"],
                                  "tol": tg["tol"]}
        out[A_JVP]["float32"] = {"max_rel_err": tg["f32"]["max_rel_err"],
                                 "rel_tol": 1e-5}
    return out


def add_counts(total: dict, counts: dict, times: int = 1) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + times * v
    return total


def trainer_launches(trial: str, iterations: int) -> dict:
    """What a trainer's run launches, from its trial's configs and
    schedule: ``calls_per_iteration`` at each iteration's step, and one
    generator forward (``g_calls_per_forward``) for each sample grid (the
    loop samples after its first iteration and every CLI_SAMPLE_EVERY)."""
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.train.schedule import schedule_from_dict
    cfg = ckpt.load_config(trial)
    gcfg, dcfg, _ = ckpt.configs_from_dict(cfg)
    schedule = schedule_from_dict(cfg["schedule"])
    want = {k: 0 for k in SOURCES}
    for i in range(iterations):
        step = schedule.state_at(i).step
        add_counts(want, calls_per_iteration(gcfg, dcfg, step))
        if i == 0 or (i + 1) % CLI_SAMPLE_EVERY == 0:
            add_counts(want, g_calls_per_forward(gcfg, step))
    return want


def synthetic_face(h: int, w: int, cx: int, cy: int, s: int) -> "np.ndarray":
    """A shaded frontal face (oval, brows, eyes, nose, mouth) at (cx, cy),
    about ``s`` pixels across, on a grey ground: RGB uint8."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    img = np.full((h, w), 120.0)
    r2 = ((yy - cy) / (0.52 * s)) ** 2 + ((xx - cx) / (0.40 * s)) ** 2
    img[r2 <= 1] = 190 - 40 * r2[r2 <= 1]
    for ex in (-0.17 * s, 0.17 * s):
        img[((yy - (cy - 0.12 * s)) / (0.05 * s)) ** 2
            + ((xx - (cx + ex)) / (0.08 * s)) ** 2 <= 1] = 55
        img[((yy - (cy - 0.22 * s)) / (0.025 * s)) ** 2
            + ((xx - (cx + ex)) / (0.10 * s)) ** 2 <= 1] = 80
    img[(np.abs(xx - cx) <= 0.035 * s) & (yy > cy - 0.1 * s)
        & (yy < cy + 0.12 * s)] = 140
    img[(np.abs(yy - (cy + 0.28 * s)) <= 0.04 * s)
        & (np.abs(xx - cx) <= 0.14 * s)] = 70
    return np.repeat(img[..., None], 3, -1).astype(np.uint8)


def cli_generate(torch, trial: str, tmp: str, cfg) -> dict:
    """cli/generate on the bf16 flagship trial, --per-class 10 (2 batches
    of 50): A 2, B 1, C 9 a batch; its images against the same z and labels
    through the plain versions on the card, to the serve phase's bf16
    tolerance; every kernel call held at its shape."""
    import numpy as np
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.cli import generate
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.schedule import schedule_from_dict
    from pgx_torch.train.wgan import make_eval_generate
    npz = os.path.join(tmp, "generated.npz")
    argv = ["--trial", trial, "--per-class", str(CLI_PER_CLASS), "--npz",
            npz, "--out", os.path.join(tmp, "generated.png"), "--device",
            DEVICE]
    _, launches, seconds, recorded = recorded_run(
        torch, lambda: generate.main(argv))
    n = cfg.num_classes * CLI_PER_CLASS
    batches = -(-n // 50)
    want = {k: 0 for k in launches}
    want.update({A: 2 * batches, B: batches, C: 9 * batches})
    require(launches == want, f"generate launches {launches} != {want}")
    with np.load(npz) as data:
        images, z, labels = data["images"], data["z"], data["labels"]
    require(images.shape == (n, 128, 128, 3) and np.isfinite(images).all(),
            f"generate: images {images.shape}")
    _, params, _, st = ckpt.load_generator_state(
        trial, schedule_from_dict(ckpt.load_config(trial)["schedule"]))
    gen = Generator.from_jax_params(cfg, params, DEVICE)
    fn = make_eval_generate(cfg, step=st.step, fading=st.fading)
    with plain_versions():
        want_img = torch.cat([fn(gen, torch.from_numpy(z[lo:lo + 50]).to(
            DEVICE), torch.from_numpy(labels[lo:lo + 50]).to(DEVICE),
            st.alpha).float() for lo in range(0, n, 50)]).cpu().numpy()
    del gen
    err = float(np.abs(images - want_img).max())
    scale = float(np.abs(want_img).max())
    tol = 0.05 * scale
    require(err <= tol, f"generate vs plain path: max abs err {err} > {tol}")
    return {"seconds": seconds, "launches": launches, "batches": batches,
            "check": {"max_abs_err": err, "mean_abs_err": float(
                np.abs(images - want_img).mean()), "ref_max_abs": scale,
                "tol": tol, "passed": True, "launches_as_predicted": True,
                "kernels_held": hold(torch, "cli generate, batch 50",
                                     recorded)}}


def cli_grow(torch, trial: str, tmp: str) -> dict:
    """cli/grow_checkpoint from the flagship trial to the 512px recipe's
    widths: both equivalence checks (G's images, D's scores, atol 1e-5 in
    the trial's bf16) must pass at step 6 on the card.  Launches: three
    generator forwards at the check step (the small and the grown net, then
    the small one's image for D) and two discriminator forwards; every
    kernel call held at its shape."""
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.cli import grow_checkpoint
    out_dir = os.path.join(tmp, "grown")
    argv = ["--trial", trial, *CLI_GROW_ARGS, "--out", out_dir,
            "--device", DEVICE]
    got, launches, seconds, recorded = recorded_run(
        torch, lambda: grow_checkpoint.main(argv))
    require(got == out_dir, f"grow_checkpoint returned {got}")
    cfg = ckpt.load_config(out_dir)
    target = [int(c) for c in CLI_GROW_ARGS[1].split(",")]
    require(cfg["generator"]["channels"] == target
            and cfg["generator"]["max_step"] == cfg["schedule"]["max_step"]
            == int(CLI_GROW_ARGS[3]), f"grown config {cfg['generator']}")
    g = ckpt.load_params(ckpt.latest_checkpoint(out_dir, "g"))
    require(str(4 * 2 ** (len(target) - 1)) in g["blocks"],
            f"grown G blocks {sorted(g['blocks'])}")
    step = int(CLI_GROW_ARGS[5])
    small_g, small_d, _ = ckpt.configs_from_dict(ckpt.load_config(trial))
    big_g, big_d, _ = ckpt.configs_from_dict(cfg)
    want = {k: 0 for k in launches}
    for gcfg in (small_g, big_g, small_g):
        add_counts(want, g_calls_per_forward(gcfg, step))
    want[A] += (d_calls_per_forward(small_d, step)
                + d_calls_per_forward(big_d, step))
    require(launches == want,
            f"grow_checkpoint launched {launches}, expected {want}")
    return {"seconds": seconds, "launches": launches,
            "check": {"equivalence_g": "passed", "equivalence_d": "passed",
                      "check_step": step, "atol": 1e-5,
                      "dtype": cfg["generator"]["dtype"],
                      "launches_as_predicted": True,
                      "kernels_held": hold(torch, "cli grow_checkpoint's "
                                           "checks, batch 4", recorded)}}


def cli_profile(torch, tmp: str) -> dict:
    """cli/profile_step at 128px (batch 32) and at 512px with the jvp
    penalty (batch 8), bf16: launches per iteration as calls_per_iteration
    gives for its TrainConfig (at 128px the train phase's), a trace that
    names kernels A and C, and ms per step over 10 timed steps with the
    least, median and largest step.  Then each config once more with every
    launch recorded, and every call held at its shape."""
    import glob
    from pgx_torch.cli import profile_step
    out = {}
    for argv, step, mode in CLI_PROFILE_RUNS:
        trace = os.path.join(tmp, f"trace_{step}")
        res, launches, seconds = counted_run(torch, lambda: profile_step.main(
            argv + ["--out", trace, "--device", DEVICE]))
        gcfg, dcfg = profile_step.flagship_configs(step, "bfloat16")
        per = calls_per_iteration(gcfg, dcfg, step, gp_mode=mode)
        if step == TRAIN_STEP and mode == "reverse":
            require(per == {**per, A: 52, A_BWD: 61, A_BWD2: 12, B: 2, C: 9,
                            C_R: 9}, f"128px iteration {per}")
        its = res["iterations"]
        require(launches == {k: v * its for k, v in per.items()},
                f"profile_step --step {step}: launches {launches} != "
                f"{its} x {per}")
        files = glob.glob(os.path.join(trace, "*.pt.trace.json"))
        require(len(files) == 1, f"trace files {files}")
        with open(files[0]) as f:
            text = f.read()
        named = {k: name in text for k, name in (
            (A, "rownorm_kernel"), (C, "conv3x3_wgmma_kernel"))}
        require(all(named.values()), f"trace names {named}")
        step_ms = res["step_ms"]
        require(len(step_ms) == int(argv[argv.index("--steps") + 1]),
                f"profile_step step times {step_ms}")
        rec_res, rec_launches, _, recorded = recorded_run(
            torch, lambda: profile_step.main(
                argv + CLI_PROFILE_RECORDED + ["--out", trace + "_recorded",
                                               "--device", DEVICE]),
)
        require(rec_launches == {k: v * rec_res["iterations"]
                                 for k, v in per.items()},
                f"profile_step --step {step}, recorded: {rec_launches}")
        out[f"step{step}"] = {
            "argv": argv, "seconds": seconds, "launches": launches,
            "iterations": its, "launches_per_iteration": per,
            "ms_per_step": res["ms_per_step"], "img_per_s": res["img_per_s"],
            "step_ms": {"least": min(step_ms),
                        "median": statistics.median(step_ms),
                        "largest": max(step_ms), "steps": len(step_ms)},
            "trace_bytes": os.path.getsize(files[0]),
            "check": {"launches_match": True, "trace_names": named,
                      "recorded_run_launches": rec_launches,
                      "kernels_held": hold(
                          torch, f"cli profile_step --step {step} "
                          f"--gp-mode {mode}", recorded)}}
    return out


def cli_augmentation_demo(torch, tmp: str) -> dict:
    """cli/augmentation_demo at 128px: the shear warp launches F twice and
    W1 and W2 once per p-row; every launch held at its shape."""
    from pgx_torch.cli import augmentation_demo
    png = os.path.join(tmp, "aug.png")
    _, launches, seconds, recorded = recorded_run(
        torch, lambda: augmentation_demo.main(
            CLI_AUG_ARGS + ["--out", png, "--device", DEVICE]))
    with open(png, "rb") as f:
        head = f.read(24)
    size = int(CLI_AUG_ARGS[-1])
    wh = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                             "big"))
    require(head[:8] == b"\x89PNG\r\n\x1a\n"
            and wh == (5 * (size + 2) + 2, CLI_AUG_ROWS * (size + 2) + 2),
            f"augmentation grid {wh}")
    want = {k: 0 for k in launches}
    want[F_] = 2 * CLI_AUG_ROWS
    want.update(shear_warp_calls(CLI_AUG_ROWS, 0))
    require(launches == want, f"augmentation_demo launched {launches}, "
                              f"expected {want}")
    return {"seconds": seconds, "launches": launches,
            "check": {"grid": list(wh), "launches_as_predicted": True,
                      "kernels_held": hold(torch, "cli augmentation_demo "
                                           "at 128px, 5 images a row",
                                           recorded)}}


def cli_trainers(torch, tmp: str) -> dict:
    """Every family trainer at its default widths on synthetic data, 4-6
    iterations over two stages: finite CSV rows at every iteration, two
    resolutions in timing.json, the samples and the final checkpoint;
    launches as ``trainer_launches`` predicts from the trial's configs and
    schedule; every kernel call held at its shape."""
    import importlib
    import math
    out = {}
    for name, (flags, total) in CLI_TRAINERS.items():
        module = importlib.import_module(f"pgx_torch.cli.{name}")
        argv = CLI_TRAIN_ARGS + flags + ["--output", os.path.join(tmp, name),
                                         "--device", DEVICE]
        trial, launches, seconds, recorded = recorded_run(
            torch, lambda: module.main(argv))
        (log,) = [n for n in os.listdir(trial) if n.startswith("train_log")]
        with open(os.path.join(trial, log)) as f:
            lines = f.read().splitlines()
        rows = [[float(v) for v in line.split(",")] for line in lines[1:]]
        require(lines[0] == "iter,g,d,grad,alpha"
                and [int(r[0]) for r in rows] == list(range(1, total + 1))
                and all(math.isfinite(v) for r in rows for v in r),
                f"{name}: CSV {lines}")
        with open(os.path.join(trial, "timing.json")) as f:
            res = [v["resolution"] for v in json.load(f).values()]
        require(len(set(res)) == 2 and res == sorted(res),
                f"{name}: resolutions {res}")
        names = set(os.listdir(os.path.join(trial, "checkpoint")))
        require({f"{total:03d}_{k}" for k in ("g.model", "d.model",
                                              "state.pt")} <= names,
                f"{name}: checkpoints {sorted(names)}")
        want = trainer_launches(trial, total)
        require(launches == want,
                f"{name}: launched {launches}, expected {want}")
        out[name] = {"trial": trial, "seconds": seconds,
                     "launches": launches, "iterations": total,
                     "resolutions": sorted(set(res)),
                     "samples": sorted(os.listdir(os.path.join(trial,
                                                               "sample"))),
                     "check": {"csv_rows": len(rows), "finite": True,
                               "launches_as_predicted": True,
                               "kernels_held": hold(
                                   torch, f"cli {name}: its run", recorded)}}
    return out


def cli_create_gif(trial: str) -> dict:
    """cli/create_gif over a trainer's sample grids (host only, PIL)."""
    from PIL import Image
    from pgx_torch.cli import create_gif
    t0 = time.perf_counter()
    out = create_gif.main(["--trial", trial, "--cell-size", "32"])
    seconds = time.perf_counter() - t0
    frames = len(os.listdir(os.path.join(trial, "sample")))
    with Image.open(out) as im:
        require(im.format == "GIF" and im.n_frames == frames,
                f"gif {im.format} {im.n_frames} frames, {frames} samples")
    return {"seconds": seconds, "check": {"frames": frames}}


def cli_prepare_data(tmp: str) -> dict:
    """cli/prepare_data square and facecrop (the default detector chain)
    on three synthetic faces and a blank image (host only, PIL)."""
    from PIL import Image
    from pgx_torch.cli import prepare_data
    src = os.path.join(tmp, "faces")
    os.makedirs(src)
    for i, (h, w, cx, cy, s) in enumerate(((160, 160, 80, 80, 80),
                                           (140, 220, 160, 70, 60),
                                           (120, 260, 195, 60, 70))):
        Image.fromarray(synthetic_face(h, w, cx, cy, s)).save(
            os.path.join(src, f"face{i}.png"))
    Image.new("RGB", (120, 80), (90, 90, 90)).save(os.path.join(src,
                                                                "blank.png"))
    t0 = time.perf_counter()
    prepare_data.main(["square", "--src", src, "--dst",
                       os.path.join(tmp, "square")])
    prepare_data.main(["facecrop", "--src", src, "--dst",
                       os.path.join(tmp, "face")])
    seconds = time.perf_counter() - t0
    square = sorted(os.listdir(os.path.join(tmp, "square")))
    faces = sorted(os.listdir(os.path.join(tmp, "face")))
    require(square == ["blank.png", "face0.png", "face1.png", "face2.png"]
            and faces == ["face0.png", "face1.png", "face2.png"],
            f"prepare_data: square {square}, facecrop {faces}")
    for d, name in (("square", "face2.png"), ("face", "face2.png")):
        with Image.open(os.path.join(tmp, d, name)) as im:
            require(im.size == (120, 120), f"{d}/{name}: {im.size}")
    from pgx_torch.data import prep
    return {"seconds": seconds, "check": {
        "square": square, "facecrop": faces,
        "detector": prep.default_face_detector().__name__}}


def cli_phase(torch, cfg, dcfg, params) -> dict:
    """Phase 7: the entry points of pgx_torch.cli beyond the flagship's
    trainer, each in this process on the card with launch counts from 0
    around it, checked against what the configs predict, and every kernel
    call it makes held against its plain version at its shape, in
    temporary directories the phase deletes.  Returns the launches summed
    over the runs."""
    import shutil
    from pgx_torch.models.discriminator import init_discriminator
    root = tempfile.mkdtemp(prefix="pgx_cli_")
    lines = {}
    try:
        trial = os.path.join(root, "flagship")
        write_flagship_trial(trial, cfg, dcfg, [params],
                             [init_discriminator(dcfg, seed=1)])
        lines["generate"] = cli_generate(torch, trial, root, cfg)
        lines["grow_checkpoint"] = cli_grow(torch, trial, root)
        for key, val in cli_profile(torch, root).items():
            lines[f"profile_step_{key}"] = val
        lines["augmentation_demo"] = cli_augmentation_demo(torch, root)
        trainers = cli_trainers(torch, root)
        lines.update(trainers)
        lines["create_gif"] = cli_create_gif(trainers[CLI_GIF_TRIAL]["trial"])
        lines["prepare_data"] = cli_prepare_data(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not os.path.exists(root), f"{root} left behind")
    total = {k: 0 for k in SOURCES}
    for entry, line in lines.items():
        line.pop("trial", None)
        emit({"phase": "cli", "entry_point": entry, **line})
        add_counts(total, line.get("launches", {}))
        add_counts(total, line.get("check", {}).get(
            "recorded_run_launches", {}))
    return {"launches": total,
            "seconds": {k: v["seconds"] for k, v in lines.items()}}


# ---------------------------------------------------------------------------
# phase 8: the 512px production recipe (gp_mode='jvp', steps_per_call)
# ---------------------------------------------------------------------------

R512_STEP = 8             # conditional_correct_grown(8): 512px
R512_BATCH = 8
R512_CHANNEL = 512
R512_GP_EVERY = 4
R512_ARGS = ["--synthetic", "--max-step", "8", "--init-step", "7",
             "--dtype", "bfloat16", "--batch-size", str(R512_BATCH),
             "--ada", "--gp-every", "4", "--fused-g", "--gp-mode", "jvp",
             "--steps-per-call", "8",
             # 24 iterations a phase (256px fade, stable, 512px fade,
             # stable): windows at 4 and 12 of each, 24-47 and 72-95 whole
             "--images-per-mini-step", str(24 * R512_BATCH),
             "--limit-images", "64", "--log-every", "24",
             "--sample-every", "48", "--checkpoint-every", "48"]
R512_PHASE = 24
R512_AUTO_ARGS = ["--synthetic", "--max-step", "8", "--init-step", "7",
                  "--dtype", "bfloat16", "--batch-size", str(R512_BATCH),
                  "--ada", "--gp-every", "4", "--fused-g", "--gp-mode",
                  "jvp", "--steps-per-call", "auto",
                  "--images-per-mini-step", str(8 * R512_BATCH),
                  "--limit-images", "64", "--log-every", "8",
                  "--sample-every", "1000", "--checkpoint-every", "1000"]


def recipe_pair(dtype: str):
    from pgx_torch.models import zoo
    gcfg, dcfg = zoo.conditional_correct_grown(
        R512_STEP, z_dim=R512_CHANNEL, channel=R512_CHANNEL,
        num_classes=10, dtype=dtype)
    return gcfg, dcfg


def recipe_launches(gen, dcfg, mode: str, apply_gp: bool) -> dict:
    """Kernel launches of one recipe iteration (fused_g, ADA with the shear
    warp), from the weights' shapes and the routing rules.  One generator
    forward under grad (B, C's residual-emitting entry, A where it takes
    the upsampled convs) and its backward (A's backward for each A); the
    pipe on the reals and on the fakes, forward and backward: F 6, W1 and
    W2 2 each, their transposes 1 each; D's real
    and fake forwards (n A each, n = D's convs, all on A) and their
    backward.  The penalty adds, with 'jvp', the frozen inner forward and
    its backward (n, n), the dual forward's primal (n A), n tangents, and in
    the reverse pass over the tangents n second derivatives, n backwards
    for the tangents' transposes and n for the primal chain; with 'reverse'
    the x_hat forward and its backward (n, n), the outer pass's n - 1
    backwards and n second derivatives."""
    g = routed_g_calls(gen, R512_STEP)
    require(g["torch_ops"] == 0, f"the recipe's generator left {g} to the "
                                 f"torch ops")
    n = sum(2 if (k == 0 or dcfg.block_type == "double") else 1
            for k in range(dcfg.entry_stage(R512_STEP) + 1))
    out = {A: 2 * n + g[A], A_BWD: 2 * n + g[A], A_BWD2: 0, A_JVP: 0,
           B: g[B], C: 0, C_R: g[C], F_: 6, D_: 0, E_: 0,
           **shear_warp_calls(2, 1)}
    if apply_gp and mode == "jvp":
        out[A] += 2 * n
        out[A_BWD] += 3 * n
        out[A_BWD2] = out[A_JVP] = n
    elif apply_gp:
        out[A] += n
        out[A_BWD] += 2 * n - 1
        out[A_BWD2] = n
    return out


def recipe_state(gcfg, dcfg, mesh=None, **tc_kw):
    """A bf16 recipe state (seed 0), the controller at ADA_P0, and its two
    steps (the penalty iteration and the plain one); ``mesh``: the steps
    over that grid (the caller shards the state)."""
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.train import TrainConfig, init_train_state, \
        make_train_step
    tc = TrainConfig(**{"gp_every": R512_GP_EVERY, "fused_g": True,
                        **tc_kw})
    state = init_train_state(gcfg, dcfg, tc, seed=0, device=DEVICE)
    state["ada"] = init_ada_state(ADA_P0, DEVICE)
    steps = {gp: make_train_step(gcfg, dcfg, tc, step=R512_STEP,
                                 fading=False, apply_gp=gp,
                                 augment_cfg=bgc_config(),
                                 ada_cfg=AdaConfig(), mesh=mesh)
             for gp in (True, False)}
    return tc, state, steps


def recipe_draws(torch, gcfg, seed: int, batch: int = R512_BATCH):
    """One iteration's real batch, labels and draws on the card, seeded."""
    from pgx_torch.train import draw_augment_sources, draw_z_eps
    rng = torch.Generator(device=DEVICE).manual_seed(seed)
    res = gcfg.resolution(R512_STEP)
    real = torch.randn(batch, res, res, 3, generator=rng,
                       device=DEVICE).clamp_(-1.0, 1.0).to(torch.bfloat16)
    labels = torch.arange(batch, device=DEVICE) % gcfg.num_classes
    z, eps = draw_z_eps(gcfg, batch, rng, dtype=real.dtype)
    return real, labels, dict(z=z, eps=eps,
                              aug_draws=draw_augment_sources(rng))


def tangent_kernel_phase(torch, calls, reps: int = 5) -> dict:
    """Kernel A's tangent at every call of one 512px jvp iteration: the
    kernel against its plain version (pgx's rule in torch ops) in f32 (1e-5
    of the largest output) and bf16 (two bf16 steps at the largest
    output); device time from a CUDA graph, back-to-back time, the plain
    version's, and the byte bound (read y and dy, write dout; b and db
    C-wide).  Then the Function's backward against autograd through the
    plain rule at the largest call (f32, 1e-4 of each gradient's largest
    entry)."""
    import math
    from pgx_torch.ops.kernels import epilogue
    rng = torch.Generator(device=DEVICE).manual_seed(31)
    uniq = {}
    for c in calls:
        uniq[c] = uniq.get(c, 0) + 1
    out = {"calls": len(calls), "ms": 0.0, "device_ms": 0.0,
           "plain_ms": 0.0, "t_bytes": 0.0, "max_abs_err": 0.0, "tol": 0.0,
           "f32": {"ms": 0.0, "plain_ms": 0.0, "t_bytes": 0.0,
                   "max_rel_err": 0.0}, "per_shape": []}
    for (shape, has_db), mult in sorted(uniq.items()):
        HELD.add((A_JVP, shape, has_db))
        row = {"shape": list(shape), "db": has_db, "calls": mult}
        c = shape[-1]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            es = torch.finfo(dt).bits // 8

            def rand(*sh, scale=1.0):
                return (torch.randn(*sh, generator=rng, device=DEVICE)
                        * scale).to(dt)
            y, dy, b = rand(*shape), rand(*shape), rand(c, scale=0.1)
            db = rand(c) if has_db else None

            def kern():
                return epilogue._launch_jvp(y, b, dy, db, 0.2, 1e-8)

            def plain():
                return epilogue.bias_pixelnorm_lrelu_jvp_ref(y, b, dy, db,
                                                             0.2, 1e-8)
            with torch.inference_mode():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                scale = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                tol = (bf16_tol(scale) if dt_name == "bfloat16"
                       else 1e-5 * scale)
                require(got.shape == want.shape and got.dtype == dt
                        and math.isfinite(err) and err <= tol,
                        f"{A_JVP} {shape} {dt_name}: max abs err {err} > "
                        f"tol {tol}")
                ms = cuda_ms(torch, kern, reps)
                plain_ms = cuda_ms(torch, plain, reps)
                device_ms = (graph_ms(torch, kern)
                             if dt_name == "bfloat16" else None)
                # A's forward at the same rows (one warp a row): beside
                # the tangent's row groups, for the speed queue
                fwd_ms = (graph_ms(torch, lambda: epilogue._launch(
                    y, b, 0.2, 1e-8)) if dt_name == "bfloat16" else None)
            nbytes = 3 * math.prod(shape) * es + c * es * (1 + has_db)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            if dt_name == "float32":
                f = out["f32"]
                f["ms"] += mult * ms
                f["plain_ms"] += mult * plain_ms
                f["t_bytes"] += mult * t_bytes
                f["max_rel_err"] = max(f["max_rel_err"],
                                       err / max(scale, 1e-30))
                row["f32"] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": t_bytes, "max_abs_err": err,
                              "tol": tol}
                continue
            out["ms"] += mult * ms
            out["device_ms"] += mult * device_ms
            out["plain_ms"] += mult * plain_ms
            out["t_bytes"] += mult * t_bytes
            if err >= out["max_abs_err"]:
                out["max_abs_err"], out["tol"] = err, tol
            row.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       bound_ms=t_bytes, max_abs_err=err, tol=tol,
                       a_forward_device_ms=fwd_ms,
                       a_forward_bound_ms=t_bytes * 2 / 3)
        out["per_shape"].append(row)
    # the Function's backward (A's backward and second-derivative kernels)
    # against autograd through the plain rule, at the call nearest 2^21
    # elements (its bias gradients sum over rows in another order)
    shape = min((c[0] for c in calls),
                key=lambda sh: abs(math.prod(sh) - 2 ** 21))
    leaves = [(torch.randn(*sh, generator=rng, device=DEVICE) * sc)
              .requires_grad_(True) for sh, sc in
              ((shape, 1.0), ((shape[-1],), 0.1), (shape, 1.0),
               ((shape[-1],), 1.0))]
    cot = torch.randn(*shape, generator=rng, device=DEVICE)
    got = torch.autograd.grad(
        epilogue.bias_pixelnorm_lrelu_tangent(*leaves), leaves, cot)
    want = torch.autograd.grad(
        epilogue.bias_pixelnorm_lrelu_jvp_ref(*leaves), leaves, cot)
    worst = max((x - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for x, w in zip(got, want))
    require(worst <= 1e-4, f"{A_JVP} backward vs autograd through the plain "
                           f"rule: {worst} of the largest entry")
    out["backward_vs_autograd_plain_rel_err"] = worst
    out["backward_shape"] = list(shape)
    out["bound_ms"] = out["t_bytes"]
    out["bound_by"] = "bytes"
    return out


def penalty_f32_check(torch, gcfg, dcfg) -> dict:
    """f32 at 512px, batch 8, TF32 off, one iteration at learning rate 0
    from one seeded state (no ADA, the penalty on): D's and G's gradients
    (Adam's mu) of the jvp penalty through the kernels against (a) the
    reverse penalty through the kernels and (b) the jvp penalty with the
    plain versions swapped in (pgx's rule through forward AD of torch ops),
    with the measures of train_f32_check; the yardstick is the reverse
    penalty with the plain versions, its fake batch moved by 3e-7 noise.
    Held to the 128px check's 3e-2 of the largest entry and 5e-3 in the
    mean, or twice the yardstick where the function is that sensitive."""
    from pgx_torch.train import TrainConfig, init_train_state, \
        make_train_step

    def run(mode, context):
        tc = TrainConfig(gp_mode=mode, learning_rate=0.0)
        g32, d32 = (dataclasses.replace(c, dtype="float32")
                    for c in (gcfg, dcfg))
        state = init_train_state(g32, d32, tc, seed=0, device=DEVICE)
        real, labels, draws = recipe_draws(torch, g32, seed=950)
        with context:
            _, metrics = make_train_step(g32, d32, tc, step=R512_STEP,
                                         fading=False)(
                state, real.float(), labels, 1.0, z=draws["z"],
                eps=draws["eps"].float())
            torch.cuda.synchronize()
        mu = {f"{net}.{n}": t.clone() for net in ("d", "g")
              for n, t in state[f"opt_{net}"]["mu"].items()}
        del state
        torch.cuda.empty_cache()
        return {k: float(v) for k, v in metrics.items()}, mu

    def worst(got, want, prefix):
        out = {"max_err_rel_to_largest_entry": 0.0,
               "mean_err_rel_to_mean": 0.0, "tensor": None}
        for name, w in want.items():
            scale = w.abs().max().item()
            if not name.startswith(prefix) or scale == 0.0:
                continue
            diff = (got[name] - w).abs()
            rel = diff.max().item() / scale
            out["mean_err_rel_to_mean"] = max(
                out["mean_err_rel_to_mean"],
                diff.mean().item() / w.abs().mean().item())
            if rel >= out["max_err_rel_to_largest_entry"]:
                out["max_err_rel_to_largest_entry"] = rel
                out["tensor"] = name
        return out

    jvp_k = run("jvp", contextlib.nullcontext())
    rev_k = run("reverse", contextlib.nullcontext())
    jvp_p = run("jvp", plain_versions())
    rev_p = run("reverse", plain_versions())
    with plain_versions():
        noisy = run("reverse", perturbed_fake(torch, 3e-7))
    stick = {net: worst(noisy[1], rev_p[1], f"{net}.") for net in ("d", "g")}
    report = {"yardstick_plain_reverse_with_3e-7_noise_on_the_fake": stick}
    for label, (got, want) in (("jvp_vs_reverse_kernels", (jvp_k, rev_k)),
                               ("jvp_kernels_vs_jvp_plain", (jvp_k, jvp_p))):
        for net in ("d", "g"):
            r = worst(got[1], want[1], f"{net}.")
            tol_max = max(3e-2, 2 * stick[net]["max_err_rel_to_largest_entry"])
            tol_mean = max(5e-3, 2 * stick[net]["mean_err_rel_to_mean"])
            require(r["max_err_rel_to_largest_entry"] <= tol_max
                    and r["mean_err_rel_to_mean"] <= tol_mean,
                    f"512px f32 {label} {net}: {r} over ({tol_max}, "
                    f"{tol_mean})")
            report[f"{label}_{net}"] = {**r, "tol_max": tol_max,
                                        "tol_mean": tol_mean}
        m_got, m_want = got[0], want[0]
        for k, v in m_want.items():
            require(abs(m_got[k] - v) <= 1e-4 + 1e-3 * abs(v),
                    f"512px f32 {label}: metric {k} {m_got[k]} vs {v}")
    report["metrics"] = {"jvp_kernels": jvp_k[0], "reverse_kernels": rev_k[0],
                         "jvp_plain": jvp_p[0]}
    return report


def profile_group(torch, run) -> dict:
    """One recipe group (the penalty iteration and gp_every - 1 plain ones)
    under torch.profiler: device kernel time, the tangent and
    rownorm launches traced, and whether torch's double backward of a conv
    ran (its aten op on the host side)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
           and not ev.is_user_annotation]       # less the program's spans
    kernel_ms = sum(ev.time_range.elapsed_us() for ev in dev) / 1e3
    host_ops = {ev.name for ev in prof.events()
                if ev.device_type == DeviceType.CPU}
    require(kernel_ms > 0, "profiler saw no device time for the recipe")
    return {"kernel_ms_per_group": kernel_ms,
            "conv_double_backward": "aten::_convolution_double_backward"
                                    in host_ops,
            "tangent_kernels_traced": sum("rownorm_jvp" in ev.name
                                          for ev in dev)}


def recipe_bare_phase(torch, gcfg, dcfg) -> dict:
    """The recipe's step (fused_g, ADA controller, shear warp, gp_every 4)
    in both penalty modes at 512px, batch 8, bf16: launch counts from 0 for
    the penalty iteration and a plain one, asserted against the routing
    rules; device ms per iteration over whole groups, img/s, peak memory,
    the host's wall time, idle share from the profile, no double backward
    of a conv in jvp mode."""
    import math
    from pgx_torch.ops import kernels as K
    out = {}
    for mode in ("jvp", "reverse"):
        _, state, steps = recipe_state(gcfg, dcfg, gp_mode=mode)
        counts = {}
        # ---- the main path: counts from 0 around each iteration ----
        for gp, seed in ((True, 1000), (False, 1001)):
            real, labels, draws = recipe_draws(torch, gcfg, seed=seed)
            K.reset_launch_counts()
            _, metrics = steps[gp](state, real, labels, 1.0, **draws)
            torch.cuda.synchronize()
            got = K.launch_counts()
            want = recipe_launches(state["g"], dcfg, mode, gp)
            require(got == want, f"512px {mode} iteration (penalty {gp}): "
                                 f"launches {got} != {want}")
            vals = {k: float(v) for k, v in metrics.items()}
            require(all(math.isfinite(v) for v in vals.values()),
                    f"512px {mode}: metrics {vals}")
            counts["penalty" if gp else "plain"] = got
        # -------------------------------------------------------------
        batches = [recipe_draws(torch, gcfg, seed=1100 + j)
                   for j in range(R512_GP_EVERY)]

        def group():
            for j, (real, labels, draws) in enumerate(batches):
                steps[j == 0](state, real, labels, 1.0, **draws)

        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, group, reps=3, warmup=1) / R512_GP_EVERY
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        group()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / R512_GP_EVERY
        prof = profile_group(torch, group)
        require(not prof["conv_double_backward"] or mode == "reverse",
                "a jvp group ran aten::_convolution_double_backward")
        kernel_ms = prof["kernel_ms_per_group"] / R512_GP_EVERY
        out[mode] = {"launches_penalty_iteration": counts["penalty"],
                     "launches_plain_iteration": counts["plain"],
                     "device_ms_per_iteration": ms,
                     "img_per_s": R512_BATCH / ms * 1e3,
                     "host_wall_ms_per_iteration": host_ms,
                     "peak_memory_bytes": peak,
                     "profiled_kernel_ms_per_iteration": kernel_ms,
                     "idle_share": max(0.0, 1.0 - kernel_ms / ms),
                     "conv_double_backward_in_profile":
                         prof["conv_double_backward"],
                     # the trace may drop short launches: beside the count
                     "tangent_kernels_traced_per_group":
                         prof["tangent_kernels_traced"]}
        del state, steps, batches
        torch.cuda.empty_cache()
    return out


def multi_step_phase(torch, gcfg, dcfg, k: int = 8) -> dict:
    """One window of make_train_multi_step(k=8) against 8 single steps on
    the same draws (jvp, the recipe's settings).  The window is the single
    step's body called in the same order, but the card's own arithmetic is
    not repeatable bit for bit: the backward of the generator's bilinear
    upsample and of the label embeddings' gather add with atomics.  So the
    comparison runs at learning rate 0 (every iteration sees the same
    weights, and no Adam step turns a rounding into a +-lr move), cuDNN in
    its deterministic mode, and holds the window to the spread of two runs
    of the 8 single steps: Adam's moments (mu, nu) and the ADA state within
    4x that spread of the largest entry (exactly equal where the two runs
    are), counts exact.  Both paths timed."""
    from pgx_torch.augment import AdaConfig, bgc_config
    from pgx_torch.train import make_train_multi_step
    batches = [recipe_draws(torch, gcfg, seed=1200 + j) for j in range(k)]
    # the draw sources replay from their generators' current states:
    # rewound before every run
    gens = [b[2]["aug_draws"][0].generator for b in batches]
    snaps = [g.get_state() for g in gens]

    def rewind():
        for g, snap in zip(gens, snaps):
            g.set_state(snap)

    def moments(state):
        out = {f"{o}.{m}.{n}": t.clone() for o in ("opt_d", "opt_g")
               for m in ("mu", "nu") for n, t in state[o][m].items()}
        out.update({f"ada.{n}": t.clone() for n, t in state["ada"].items()})
        return out

    def spread(x, y):
        worst, name = 0.0, None
        for n, t in x.items():
            scale = max(t.abs().max().item(), 1e-30)
            rel = (t - y[n]).abs().max().item() / scale
            if rel > worst:
                worst, name = rel, n
        return worst, name

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for label in ("singles", "singles_again", "window"):
            tc, state, steps = recipe_state(gcfg, dcfg, gp_mode="jvp",
                                            learning_rate=0.0)
            rewind()
            if label == "window":
                fn = make_train_multi_step(gcfg, dcfg, tc, step=R512_STEP,
                                           fading=False, k=k,
                                           augment_cfg=bgc_config(),
                                           ada_cfg=AdaConfig())
                run = lambda: fn(state, [b[0] for b in batches],
                                 [b[1] for b in batches], [1.0] * k,
                                 draws=[(b[2]["z"], b[2]["eps"],
                                         b[2]["aug_draws"])
                                        for b in batches])
            else:
                def run():
                    for j, (real, labels, draws) in enumerate(batches):
                        steps[j % R512_GP_EVERY == 0](state, real, labels,
                                                      1.0, **draws)
            run()
            torch.cuda.synchronize()
            require(state["iteration"] == k and state["opt_d"]["count"] == k,
                    f"{label}: iteration {state['iteration']}")
            runs[label] = moments(state)
            ms = cuda_ms(torch, lambda: (rewind(), run()), reps=2, warmup=0)
            runs[label + "_ms"] = ms
            del state, steps
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    noise, noise_at = spread(runs["singles_again"], runs["singles"])
    err, err_at = spread(runs["window"], runs["singles"])
    require(err <= 4.0 * noise, f"a window of {k} vs {k} single steps: "
                                f"{err} at {err_at}, two runs of the single "
                                f"steps {noise} at {noise_at}")
    return {"k": k, "learning_rate": 0.0,
            "window_vs_singles_max_rel_err": err, "at": err_at,
            "singles_vs_singles_max_rel_err": noise, "noise_at": noise_at,
            "bitwise_equal": err == 0.0,
            "device_ms_8_single_steps": runs["singles_ms"],
            "device_ms_one_window": runs["window_ms"]}


def memory_variants_phase(torch, gcfg, dcfg) -> dict:
    """The recipe's jvp step with remat off, each remat policy, and
    weights_cast='once': peak memory and device ms per iteration over a
    whole group of gp_every iterations."""
    out = {}
    for label, kw in (("remat_off", {}),
                      ("remat_full", dict(remat=True, remat_policy="full")),
                      ("remat_convs", dict(remat=True,
                                           remat_policy="convs")),
                      ("remat_d_only", dict(remat=True,
                                            remat_policy="d_only")),
                      ("weights_cast_once", dict(weights_cast="once"))):
        _, state, steps = recipe_state(gcfg, dcfg, gp_mode="jvp", **kw)
        batches = [recipe_draws(torch, gcfg, seed=1300 + j)
                   for j in range(R512_GP_EVERY)]

        def group():
            for j, (real, labels, draws) in enumerate(batches):
                steps[j == 0](state, real, labels, 1.0, **draws)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, group, reps=2, warmup=1) / R512_GP_EVERY
        out[label] = {"peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "device_ms_per_iteration": ms,
                      "img_per_s": R512_BATCH / ms * 1e3}
        del state, steps, batches
    torch.cuda.empty_cache()
    return out


def recipe_cli_phase(torch) -> dict:
    """The recipe through the flagship's CLI in this process (full width,
    512px, bf16, batch 8, ADA, gp_every 4, fused_g, jvp, steps_per_call 8),
    256px fade/stable then 512px fade/stable, 24 iterations each: launch
    counts from 0 around it, the windows and single steps counted, img/s
    per phase from timing.json, finite CSV rows, peak memory.  Then a short
    run with --steps-per-call auto, reporting the window it chose per
    stage."""
    import glob
    import math
    import shutil
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    from pgx_torch.ops import kernels as K
    from pgx_torch.train import loop as loop_mod

    windows, singles, chosen = [], [], []
    orig_multi, orig_step = (loop_mod.make_train_multi_step,
                             loop_mod.make_train_step)
    orig_auto = loop_mod._auto_k

    def counted_multi(*a, **kw):
        fn = orig_multi(*a, **kw)

        def run(state, *ra, **rkw):
            windows.append((kw["step"], kw["fading"], state["iteration"],
                            kw["k"]))
            return fn(state, *ra, **rkw)
        return run

    def counted_step(*a, **kw):
        fn = orig_step(*a, **kw)

        def run(state, *ra, **rkw):
            singles.append((kw["step"], kw["fading"], state["iteration"]))
            return fn(state, *ra, **rkw)
        return run

    def recorded_auto(ms, gp_every):
        k = orig_auto(ms, gp_every)
        chosen.append({"ms_per_step": ms, "k": k})
        return k

    root = tempfile.mkdtemp(prefix="pgx_recipe_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(loop_mod, "make_train_multi_step",
                               counted_multi), \
                mock.patch.object(loop_mod, "make_train_step",
                                  counted_step):
            # ---- the main path: counts from 0 around the CLI run ----
            K.reset_launch_counts()
            t0 = time.perf_counter()
            trial = cli.main(R512_ARGS + ["--output",
                                          os.path.join(root, "run")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            # ----------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        (log,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
        with open(log) as f:
            lines = f.read().splitlines()
        rows = [[float(v) for v in line.split(",")] for line in lines[1:]]
        require([int(r[0]) for r in rows] == [24, 48, 72, 96]
                and all(math.isfinite(v) for r in rows for v in r),
                f"recipe CSV {lines}")
        with open(os.path.join(trial, "timing.json")) as f:
            timing = json.load(f)
        require({k: v["resolution"] for k, v in timing.items()}
                == {"24": 256, "48": 256, "72": 512, "96": 512},
                f"recipe timing.json {timing}")
        # the loop's own single steps (a window's body is the step module's
        # make_train_step, not the loop's) and its windows, per phase
        phases = {}
        for p, name in enumerate(("256px fade", "256px stable",
                                  "512px fade", "512px stable")):
            lo, hi = p * R512_PHASE, (p + 1) * R512_PHASE
            phases[name] = {
                "img_per_s_timing_json": timing[str(hi)]["img_s"],
                "windows": sum(lo <= w[2] < hi for w in windows),
                "iterations_in_windows": sum(w[3] for w in windows
                                             if lo <= w[2] < hi),
                "iterations_alone": sum(lo <= s[2] < hi for s in singles)}
            require(phases[name]["windows"] >= 2,
                    f"recipe {name}: {phases[name]['windows']} windows")
        in_windows = sum(w[3] for w in windows)
        alone = len(singles)
        require(in_windows + alone == 4 * R512_PHASE,
                f"recipe: {in_windows} iterations in windows and {alone} "
                f"alone")
        for name in (A, A_BWD, A_BWD2, A_JVP, B, C_R, F_, W1, W1_T, W2,
                     W2_T):
            require(launches[name] > 0, f"recipe CLI run: {name} not "
                                        f"launched ({launches})")

        # ---- --steps-per-call auto: the window chosen per stage ----
        with mock.patch.object(loop_mod, "_auto_k", recorded_auto):
            t1 = time.perf_counter()
            cli.main(R512_AUTO_ARGS + ["--output", os.path.join(root,
                                                                "auto")])
            auto_wall = time.perf_counter() - t1
        require(len(chosen) == 2, f"auto chose {chosen} (one per stage)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"config": "python -m pgx_torch.cli.conditional_proper_cifar_train "
                      + " ".join(R512_ARGS),
            "iterations": 4 * R512_PHASE, "launches": launches,
            "wall_s": wall, "peak_memory_bytes": peak, "csv": rows,
            "timing": timing, "phases": phases,
            "iterations_in_windows": in_windows,
            "iterations_alone": alone,
            "windows": [list(w) for w in windows],
            "auto": {"config": " ".join(R512_AUTO_ARGS),
                     "chosen_per_stage": [
                         {"stage": s, **c} for s, c in zip((7, 8), chosen)],
                     "wall_s": auto_wall}}


def record_a_calls_512(torch, gcfg, dcfg):
    """Every launch of kernel A's family and of kernel C in one bf16 512px
    jvp penalty iteration, recorded where it launches: A, B, A's backward
    and C (its plain or its residual-emitting entry) as kernel_phase's
    (name, shape, weight shapes, options) calls; A's second derivative as
    second_order_phase's (shape, slope, ddy given, ddb given, the outputs
    it needs); A's tangent as (shape, db given).  The counts are held
    against the routing rules."""
    import importlib
    from pgx_torch.ops.kernels import conv_epilogue, epilogue
    pn = importlib.import_module("pgx_torch.ops.kernels.pixel_norm_lrelu")
    calls, second, tangent = [], [], []
    fwd, bwd, pn_fwd = epilogue._launch, epilogue._launch_backward, pn._launch
    so, jvp = epilogue._launch_second_order, epilogue._launch_jvp
    conv = conv_epilogue._launch

    def rec(name, fn):
        def run(y, *rest):
            bias = (tuple(rest[0].shape),) if name != B else ()
            calls.append((name, tuple(y.shape), bias,
                          json.dumps({"slope": rest[-2]}, sort_keys=True)))
            return fn(y, *rest)
        return run

    def rec_so(y, b, g, ddy, ddb, slope, eps, needs):
        second.append((tuple(y.shape), slope, ddy is not None,
                       ddb is not None, tuple(needs)))
        return so(y, b, g, ddy, ddb, slope, eps, needs)

    def rec_jvp(y, b, dy, db, slope, eps):
        tangent.append((tuple(y.shape), db is not None))
        return jvp(y, b, dy, db, slope, eps)

    def rec_conv(x, w, b, use_pixel_norm, slope, eps, emit_r):
        opts = {"slope": slope}
        if not emit_r:
            opts["use_pixel_norm"] = use_pixel_norm
        calls.append((C_R if emit_r else C, tuple(x.shape),
                      (tuple(w.shape), tuple(b.shape)),
                      json.dumps(opts, sort_keys=True)))
        return conv(x, w, b, use_pixel_norm, slope, eps, emit_r)
    _, state, steps = recipe_state(gcfg, dcfg, gp_mode="jvp")
    real, labels, draws = recipe_draws(torch, gcfg, seed=901)
    with mock.patch.object(epilogue, "_launch", rec(A, fwd)), \
            mock.patch.object(epilogue, "_launch_backward", rec(A_BWD, bwd)), \
            mock.patch.object(pn, "_launch", rec(B, pn_fwd)), \
            mock.patch.object(epilogue, "_launch_second_order", rec_so), \
            mock.patch.object(epilogue, "_launch_jvp", rec_jvp), \
            mock.patch.object(conv_epilogue, "_launch", rec_conv):
        steps[True](state, real, labels, 1.0, **draws)
        torch.cuda.synchronize()
    want = recipe_launches(state["g"], dcfg, "jvp", True)
    del state, steps
    counted = {**count_calls(calls), A_BWD2: len(second),
               A_JVP: len(tangent)}
    keys = (A, B, A_BWD, A_BWD2, A_JVP, C, C_R)
    got = {k: counted.get(k, 0) for k in keys}
    require(got == {k: want[k] for k in keys},
            f"recorded launches of A's family and C {got}, the routing rules "
            f"give {want}")
    return calls, second, tangent


def a512_summary(launches, device_ms, ms, plain_ms, bound_ms, bound_by,
                 max_abs_err, tol) -> dict:
    return {"launches": launches, "device_ms": device_ms, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / device_ms,
            "max_abs_err": max_abs_err, "tol": tol}


def a512_rows(kernel, per_shape) -> list:
    """Per-shape rows of one kernel of A's family: C, rows, launches,
    device ms a launch, its bound and the share."""
    import math
    return [{"kernel": kernel, "c": r["shape"][-1],
             "rows": math.prod(r["shape"][:-1]), "launches": r["calls"],
             "device_ms": r["device_ms"], "bound_ms": r["bound_ms"],
             "share_of_bound": r["bound_ms"] / r["device_ms"]}
            for r in per_shape]


def c512_rows(per_shape) -> list:
    """Per-shape rows of kernel C's residual-emitting entry: C_in, C_out,
    rows, launches, device ms a launch, its bound, the share, and cuDNN's
    conv + bias at the same shape."""
    import math
    return [{"kernel": C_R, "c_in": r["shape"][-1],
             "c_out": r["wshapes"][0][-1],
             "rows": math.prod(r["shape"][:-1]), "launches": r["calls"],
             "device_ms": r["device_ms"], "bound_ms": r["bound_ms"],
             "share_of_bound": r["bound_ms"] / r["device_ms"],
             "cudnn_conv_bias_ms": r["cudnn_conv_bias_ms"]}
            for r in per_shape]


def c512_phase(torch, calls, per: str) -> dict:
    """Kernel C's residual-emitting entry (the recipe's generator runs no
    plain C: record_a_calls_512 holds that) at every launch of one bf16
    512px jvp penalty iteration: kernel_phase's checks against the plain
    version and its times in bf16 and f32 (its operations bound, cuDNN's
    conv + bias beside it), summed and per shape."""
    t0 = time.monotonic()
    per_c = kernel_phase(torch, calls, per, reps=3)
    agg, f32 = per_c[(C_R, "bfloat16")], per_c[(C_R, "float32")]
    return {
        **a512_summary(
            agg["calls"], agg["device_ms"], agg["ms"], agg["plain_ms"],
            max(agg["t_ops"], agg["t_bytes"]),
            "operations" if agg["t_ops"] > agg["t_bytes"] else "bytes",
            agg["err"], agg["tol"]),
        "cudnn_conv_bias_ms": agg["conv_ms"],
        "f32": {"ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": max(f32["t_ops"], f32["t_bytes"]),
                "cudnn_conv_bias_ms": f32["conv_ms"],
                "max_abs_err": f32["err"], "tol": f32["tol"]},
        "per_shape": c512_rows(agg["per_shape"]),
        "seconds": time.monotonic() - t0}


def recipe_phase(torch) -> dict:
    """Phase 8: the 512px production recipe at full width."""
    gcfg, dcfg = recipe_pair("bfloat16")
    per = "one bf16 jvp penalty iteration at 512px, batch 8"
    calls, second, tangent_calls = record_a_calls_512(torch, gcfg, dcfg)
    c_calls = [c for c in calls if c[0] in (C, C_R)]
    calls = [c for c in calls if c[0] not in (C, C_R)]
    tangent = tangent_kernel_phase(torch, tangent_calls)
    emit({"phase": "kernel_a_tangent", "per": per, **tangent})
    per_a = kernel_phase(torch, calls, per, reps=3)
    so = second_order_phase(torch, second, reps=3)
    a512, rows = {}, []
    for (name, dt), agg in per_a.items():
        if dt != "bfloat16":
            continue
        t = max(agg["t_ops"], agg["t_bytes"])
        a512[name] = a512_summary(
            agg["calls"], agg["device_ms"], agg["ms"], agg["plain_ms"], t,
            "operations" if agg["t_ops"] > agg["t_bytes"] else "bytes",
            agg["err"], agg["tol"])
        rows += a512_rows(name, agg["per_shape"])
    a512[A_BWD2] = a512_summary(
        so["calls"], so["device_ms"], so["ms"], so["plain_ms"],
        so["bound_ms"], so["bound_by"], so["max_abs_err"], so["tol"])
    rows += a512_rows(A_BWD2, so["per_shape"])
    a512[A_JVP] = a512_summary(
        tangent["calls"], tangent["device_ms"], tangent["ms"],
        tangent["plain_ms"], tangent["bound_ms"], tangent["bound_by"],
        tangent["max_abs_err"], tangent["tol"])
    rows += a512_rows(A_JVP, tangent["per_shape"])
    emit({"phase": "kernel_a_512px", "per": per + " (sum over its "
          "launches)", **a512, "per_shape": rows})
    c512 = c512_phase(torch, c_calls, per)
    emit({"phase": "kernel_c_512px", "kernel": C_R, "per": per + " (sum "
          "over its launches; f32 timed at every shape)", **c512})
    emit({"phase": "train_512_penalty_f32_check",
          **penalty_f32_check(torch, gcfg, dcfg)})
    bare = recipe_bare_phase(torch, gcfg, dcfg)
    emit({"phase": "train_512_recipe", "config": "conditional_correct_grown("
          "8, z_dim=512, channel=512, num_classes=10), bf16, batch 8, 512px, "
          "ADA (AdaConfig(), shear warp), gp_every=4, fused_g", **bare})
    emit({"phase": "train_512_multi_step",
          **multi_step_phase(torch, gcfg, dcfg)})
    emit({"phase": "train_512_memory_variants", "gp_mode": "jvp",
          **memory_variants_phase(torch, gcfg, dcfg)})
    cli_run = recipe_cli_phase(torch)
    emit({"phase": "train_512_cli", **cli_run})
    return {"tangent": tangent, "bare": bare, "cli": cli_run, "a512": a512,
            "c512": c512}


# ---------------------------------------------------------------------------
# phase 9: evaluation (Inception FID/KID, the sweep, the .model round trip)
# ---------------------------------------------------------------------------

EVAL_BATCH = 50
EVAL_SAMPLES = 2048       # a side: pool3 has 2048 dimensions, fewer images
                          # leave both covariances singular
EVAL_ITERS = (100,)       # past the schedule's end: step 6, 128px, alpha 1
# (one checkpoint: each costs the sweep ~45 s of host sqrtm and KID on its
# own, and a second one scored the same code path again)
SWEEP_ARGS = ["--kid", "--dataset", "synthetic", "--num-samples",
              str(EVAL_SAMPLES), "--num-real", str(EVAL_SAMPLES),
              "--batch-size", str(EVAL_BATCH)]
F32_CONV_OPS = 67e12      # Inception's convs: f32 outside the tensor cores
# the tracer's own spans on the device timeline (CUPTI's buffer handling)
TRACER_SPANS = ("Activity Buffer Request", "Buffer Flush")


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host time of fn() to its end on the card (synchronized)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def eval_preprocess_phase(torch) -> dict:
    """The device preprocess against the numpy path (``_resize_batch`` and
    the float chain): bytes after the resize equal, floats equal, for a
    real 32px batch, a 128px float generator batch and a grey 32px batch;
    then both timed on the 128px batch of 50."""
    import numpy as np
    from pgx_torch.data.datasets import _resize_batch, synthetic_dataset
    from pgx_torch.eval import fid
    cases = {
        "real_32px_uint8": synthetic_dataset(EVAL_BATCH, 32, 3,
                                             seed=3).images,
        "fake_128px_float32": np.random.RandomState(7).randn(
            EVAL_BATCH, 128, 128, 3).astype(np.float32),
        "grey_32px_uint8": synthetic_dataset(EVAL_BATCH, 32, 1,
                                             seed=4).images}
    for name, x in cases.items():
        u8 = fid._rgb_uint8(x)
        got = fid.resize_uint8(torch.from_numpy(u8).to(DEVICE), 299)
        require(np.array_equal(got.cpu().numpy(), _resize_batch(u8, 299)),
                f"device resize differs from the numpy path ({name})")
        got = fid.preprocess(x, DEVICE)
        require(got.shape == (len(x), 299, 299, 3)
                and got.dtype == torch.float32, f"preprocess {name} shape")
        require(np.array_equal(got.cpu().numpy(),
                               fid.preprocess(x, "cpu").numpy()),
                f"device preprocess floats differ from the numpy path "
                f"({name})")
    x = cases["fake_128px_float32"]
    u8_dev = torch.from_numpy(fid._rgb_uint8(x)).to(DEVICE)
    return {"cases": list(cases), "bytes_equal": True, "floats_equal": True,
            "per": "one batch of 50 at 128px, float32 generator output",
            "device_ms": wall_ms(torch, lambda: fid.preprocess(x, DEVICE)),
            "device_resize_and_lookup_ms": cuda_ms(
                torch, lambda: fid._preprocess_tensor(u8_dev), reps=5),
            "host_quirk_ms": wall_ms(torch, lambda: fid._rgb_uint8(x)),
            "numpy_host_path_ms": wall_ms(
                torch, lambda: fid.preprocess(x, "cpu"), reps=3)}


def inception_flops(torch, model) -> float:
    """Operations of one image's forward, from the convs' shapes: the sum
    of 2 * kh * kw * C_in * C_out * H_out * W_out (a forward hook on every
    conv reads its output's size)."""
    total = []

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        total.append(2.0 * kh * kw * mod.in_channels * mod.out_channels
                     * out.shape[2] * out.shape[3])
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, 3, 299, 299, device=DEVICE).contiguous(
                memory_format=torch.channels_last))
    finally:
        for h in handles:
            h.remove()
    require(len(total) == 94, f"{len(total)} convs in Inception, want 94")
    return sum(total)


def eval_features_phase(torch) -> dict:
    """The card's f32 Inception features against the CPU's with the same
    random weights on one batch of 8 (tolerance 1e-4 of the largest
    feature); the caller's TF32 flags left on around a call do not move
    them (the extractor turns TF32 off for its call and restores the flags:
    1e-6 of the largest feature) and what TF32 would have moved, the model
    called outside the extractor with TF32 on; then Inception's time per
    batch of 50 against its f32 bound."""
    import numpy as np
    from pgx_torch.eval import fid, inception
    sd = inception.init_inception(torch.Generator().manual_seed(0))
    x = fid.preprocess(np.random.RandomState(8).randn(8, 128, 128, 3)
                       .astype(np.float32), "cpu")
    want = fid.make_extractor(sd, device="cpu")(x)
    ext = fid.make_extractor(sd, device=DEVICE)
    xd = x.to(DEVICE).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        left_on = ext(x)
        require(torch.backends.cudnn.allow_tf32
                and torch.backends.cuda.matmul.allow_tf32,
                "the extractor did not restore the caller's TF32 flags")
        with torch.inference_mode():
            tf32 = ext.model(xd).cpu().numpy()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    got = ext(x)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    flag_err = float(np.abs(left_on - got).max()) / scale
    require(got.shape == (8, 2048) and np.isfinite(got).all(),
            "card features' shape or values")
    require(err <= 1e-4, f"card features vs CPU: {err} of the largest "
                         f"feature > 1e-4")
    require(flag_err <= 1e-6, f"features moved with the caller's TF32 "
                              f"flags on: {flag_err} of the largest")
    flops = inception_flops(torch, ext.model)
    xb = torch.randn(EVAL_BATCH, 3, 299, 299, device=DEVICE).contiguous(
        memory_format=torch.channels_last)

    def batch():
        with torch.inference_mode():
            ext.model(xb)
    ms = cuda_ms(torch, batch, reps=10)
    bound = EVAL_BATCH * flops / F32_CONV_OPS * 1e3
    return {"features_vs_cpu_rel_err": err, "tol": 1e-4,
            "features_with_caller_tf32_on_rel_err": flag_err,
            "tf32_unscoped_rel_err": float(np.abs(tf32 - want).max()) / scale,
            "largest_feature": scale,
            "gflop_per_image": flops / 1e9,
            "inception_ms_per_batch50": ms,
            "inception_img_per_s": EVAL_BATCH / ms * 1e3,
            "inception_bound_ms_per_batch50": bound,
            "inception_share_of_bound": bound / ms, "bound_by": "operations"}


def device_launches(torch, fn) -> int:
    """Kernels, copies and sets on the device in one fn() call, from the
    profiler's raw trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type() == DeviceType.CUDA
               and not ev.is_user_annotation()
               and ev.name() not in TRACER_SPANS
               for ev in prof.profiler.kineto_results.events())


def write_flagship_trial(trial, cfg, dcfg, g_trees, d_trees) -> None:
    """The flagship as a trial the loop would leave: its config with a
    schedule, G and D npz checkpoints at EVAL_ITERS."""
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.train import ProperSchedule, TrainConfig
    from pgx_torch.train.schedule import schedule_to_dict
    ckpt.save_config(trial, cfg, dcfg, TrainConfig(), postfix="flagship",
                     extra={"batch_size": TRAIN_BATCH,
                            "schedule": schedule_to_dict(ProperSchedule(
                                96, TRAIN_BATCH, cfg.max_step,
                                cfg.max_step))})
    os.makedirs(os.path.join(trial, "checkpoint"))
    for it, g, d in zip(EVAL_ITERS, g_trees, d_trees):
        for kind, tree in (("g", g), ("d", d)):
            ckpt.save_params(os.path.join(trial, "checkpoint",
                                          ckpt.checkpoint_name(it, kind)),
                             tree)


@contextlib.contextmanager
def sweep_probes(torch, profiled: int | None = None):
    """Host time of each of the sweep's parts (none of it changes what the
    sweep does): sampling (to the host copy), activations (preprocess and
    Inception, to the host copy), the Frechet distance (scipy's sqrtm) and
    KID.  With ``profiled`` = i, the i-th scored checkpoint runs under
    torch.profiler (device activity only) from its first sample to its
    KID; without it nothing is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pgx_torch.eval import sweep
    probes = {"generate_s": [], "activations_s": [], "frechet_s": [],
              "kid_s": []}
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}

    def timed(name, fn):
        def run(*a, **kw):
            if name == "generate_s" and len(probes[name]) == profiled:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            probes[name].append(time.perf_counter() - t0)
            if "t0" in window and name == "kid_s" \
                    and len(probes[name]) == profiled + 1:
                torch.cuda.synchronize()
                window["wall_s"] = time.perf_counter() - window["t0"]
                prof.stop()
            return out
        return run

    with contextlib.ExitStack() as stack:
        for attr, name in (("generate_samples", "generate_s"),
                           ("get_activations", "activations_s"),
                           ("calculate_frechet_distance", "frechet_s"),
                           ("kid_from_activations", "kid_s")):
            stack.enter_context(mock.patch.object(
                sweep, attr, timed(name, getattr(sweep, attr))))
        yield probes
    if profiled is None:
        return
    require("wall_s" in window, "the profiled checkpoint was not scored")
    # the raw trace (a million device events where cuDNN picks its
    # per-slice FFT algorithm; torch's event tree would take minutes), less
    # the tracer's own spans on the device timeline
    dev = [ev for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA
           and not ev.is_user_annotation() and ev.name() not in TRACER_SPANS]
    kernel_s = sum(ev.duration_ns() for ev in dev) / 1e9
    wall = window["wall_s"]
    require(0 < kernel_s < wall, f"profiled scoring: device {kernel_s} s in "
                                 f"{wall} s")
    probes["profile"] = {"wall_s": wall, "profiled_device_s": kernel_s,
                         "device_events": len(dev),
                         "idle_share": 1.0 - kernel_s / wall}


def read_scores(trial: str):
    with open(os.path.join(trial, "fid_score.json")) as f:
        fids = json.load(f)
    with open(os.path.join(trial, "kid_score.json")) as f:
        kids = json.load(f)
    return fids, kids


def counted_sweep(torch, trial: str, dtype: str) -> dict:
    """One main path: cli/fid_sweep --kid on ``trial`` with launch counts
    from 0 around it and nothing traced (A 2, B 1, C 9 per sampling batch;
    finite FID and KID for every checkpoint; the seconds per checkpoint of
    the whole run and the host time of each part)."""
    import math
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.cli import fid_sweep
    from pgx_torch.ops import kernels as K
    with sweep_probes(torch) as probes:
        # ---- the main path: counts from 0 around the sweep ----
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = fid_sweep.main(["--trial", trial] + SWEEP_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        # --------------------------------------------------------
    batches = len(EVAL_ITERS) * math.ceil(EVAL_SAMPLES / EVAL_BATCH)
    want = {k: 0 for k in launches}
    want.update({A: 2 * batches, B: batches, C: 9 * batches})
    require(launches == want, f"{dtype} sweep launches {launches} != {want} "
                              f"({batches} sampling batches)")
    names = [ckpt.checkpoint_name(it, "g") for it in EVAL_ITERS]
    fids, kids = read_scores(trial)
    require(sorted(fids) == sorted(kids) == sorted(names)
            and all(math.isfinite(v) for v in fids.values())
            and all(math.isfinite(m) and math.isfinite(sd)
                    for m, sd in kids.values()),
            f"{dtype} sweep scores {fids} {kids}")
    require(set(result["comparable"]) == set(names)
            and not result["in_training"], f"sweep result {result}")
    return {"config": f"python -m pgx_torch.cli.fid_sweep --trial <{dtype} "
                      f"trial> " + " ".join(SWEEP_ARGS),
            "sampling_dtype": dtype, "fid": fids, "kid": kids,
            "launches": launches, "sampling_batches": batches,
            "launches_per_sampling_batch": {
                k: launches[k] / batches for k in (A, B, C)},
            "wall_s": wall, "seconds_per_checkpoint": wall / len(names),
            "generate_s": probes["generate_s"],
            # the checkpoint's samples, then the 2048 real images
            "activations_s": probes["activations_s"],
            "frechet_s": probes["frechet_s"], "kid_s": probes["kid_s"]}


def profiled_checkpoint(torch, trial: str) -> dict:
    """The device idle share of one checkpoint's scoring, outside every
    timed window: the last checkpoint's scores dropped from the trial's
    files, then cli/fid_sweep scores it alone under torch.profiler, from
    its first sample to its KID (its samples, both sides' activations,
    sqrtm, KID)."""
    import math
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.cli import fid_sweep
    name = ckpt.checkpoint_name(EVAL_ITERS[-1], "g")
    fids, kids = read_scores(trial)
    for fname, scores in (("fid_score.json", fids), ("kid_score.json", kids)):
        with open(os.path.join(trial, fname), "w") as f:
            json.dump({k: v for k, v in scores.items() if k != name}, f)
    with sweep_probes(torch, profiled=0) as probes:
        fid_sweep.main(["--trial", trial] + SWEEP_ARGS)
    again, _ = read_scores(trial)
    require(sorted(again) == sorted(fids) and math.isfinite(again[name]),
            f"profiled re-score {again}")
    return {"checkpoint": name, **probes["profile"],
            "generate_s": probes["generate_s"][0],
            "activations_s": probes["activations_s"],
            "frechet_s": probes["frechet_s"][0], "kid_s": probes["kid_s"][0],
            "fid": again[name], "fid_unprofiled": fids[name]}


def eval_kernel_phase(torch, cfg, icfg, params) -> dict:
    """A, B and C against their plain versions at the eval paths' sampling
    shapes, recorded from ``sweep.generate_samples``: one batch of 50 at
    128px as the sweep samples the imported trial (f32); the loop's FID
    ticks (256 samples at batch 50, bf16) at 64px and 128px, whose batches
    of 50 at 128px are the sweep's shapes and whose other shapes (64px at
    50 and 6, 128px at 6) are held on their own.  kernel_phase holds every
    shape in bf16 and f32."""
    from pgx_torch.eval import sweep
    from pgx_torch.models.generator import Generator

    def sampled(c, step, n):
        gen = Generator.from_jax_params(c, params, DEVICE)
        return lambda: sweep.generate_samples(
            gen, c, step=step, alpha=1.0, fading=False, num_samples=n,
            batch_size=EVAL_BATCH, seed=0, num_classes=c.num_classes)
    rem = LOOP_FID_SAMPLES % EVAL_BATCH
    sweep_calls = record_calls(torch, sampled(icfg, icfg.max_step,
                                              EVAL_BATCH))
    tick_128 = record_calls(torch, sampled(cfg, cfg.max_step,
                                           EVAL_BATCH + rem))
    tick_64 = record_calls(torch, sampled(cfg, cfg.max_step - 1,
                                          EVAL_BATCH + rem))
    n = len(sweep_calls)
    require(count_calls(sweep_calls) == {A: 2, B: 1, C: 9}
            and tick_128[:n] == sweep_calls,
            f"the sweep's f32 batch {count_calls(sweep_calls)} and the "
            f"tick's bf16 batch of 50 at 128px differ in their calls")
    batch50 = kernel_phase(torch, sweep_calls, "one sampling batch of 50 at "
                           "128px (the sweep's in f32, the FID tick's in "
                           "bf16)", reps=3)
    others = kernel_phase(torch, tick_128[n:] + tick_64, "the FID ticks' "
                          "other sampling batches: 128px at 6, 64px at 50 "
                          "and 6", reps=3)
    return {"batch50": batch50, "tick_others": others}


def eval_sweep_phase(torch, cfg, dcfg, params) -> dict:
    """The flagship (random weights from seed 0) as a bf16 trial of one
    checkpoint; exported to reference .model files
    (cli/export_torch_checkpoint) and imported back (cli/import_checkpoint
    --sample): every parameter byte for byte.  Then two main paths, each
    cli/fid_sweep --kid with 2048 samples and 2048 synthetic real images at
    batch 50 and counts from 0 around it: the imported trial (its config
    carries no dtype: f32 sampling) and the bf16 trial, then a second sweep
    of the imported trial that scores nothing (no launch, the files
    unchanged).  Then one checkpoint of the bf16 trial scored again under
    torch.profiler (the idle share), A, B and C against their plain
    versions at the eval paths' shapes, and G's sampling time per batch."""
    import shutil
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.cli import export_torch_checkpoint, fid_sweep, \
        import_checkpoint
    from pgx_torch.models.discriminator import init_discriminator
    from pgx_torch.models.generator import Generator
    from pgx_torch.ops import kernels as K
    from pgx_torch.train.wgan import make_eval_generate

    root = tempfile.mkdtemp(prefix="pgx_eval_")
    out = {}
    try:
        orig = os.path.join(root, "trial_flagship")
        g_trees = [params]
        d_trees = [init_discriminator(dcfg, seed=10)]
        write_flagship_trial(orig, cfg, dcfg, g_trees, d_trees)
        ref, imported = (os.path.join(root, n) for n in ("ref", "imported"))
        t0 = time.perf_counter()
        export_torch_checkpoint.main(["--trial", orig, "--out", ref])
        t1 = time.perf_counter()
        import_checkpoint.main(["--trial", ref, "--family",
                                "conditional_proper", "--num-classes",
                                str(cfg.num_classes), "--out", imported,
                                "--sample"])
        t2 = time.perf_counter()
        leaves = 0
        for it in EVAL_ITERS:
            for kind in ("g", "d"):
                name = ckpt.checkpoint_name(it, kind)
                a = ckpt._flatten(ckpt.load_params(
                    os.path.join(orig, "checkpoint", name)))
                b = ckpt._flatten(ckpt.load_params(
                    os.path.join(imported, "checkpoint", name)))
                require(a.keys() == b.keys() and all(
                    a[k].dtype == b[k].dtype and a[k].tobytes()
                    == b[k].tobytes() for k in a),
                    f"round trip changed {name}")
                leaves += len(a)
            require(os.path.getsize(os.path.join(
                imported, "sample", f"{it:03d}_imported.png")) > 0,
                f"no imported sample grid at {it}")
        icfg, _, _ = ckpt.configs_from_dict(ckpt.load_config(imported))
        require(dataclasses.replace(icfg, dtype=cfg.dtype) == cfg,
                f"imported generator config {icfg}")
        out["round_trip"] = {"leaves_byte_equal": leaves,
                             "export_s": t1 - t0, "import_sample_s": t2 - t1,
                             "imported_dtype": icfg.dtype}
        emit({"phase": "eval_round_trip", **out["round_trip"]})

        out["sweep"] = counted_sweep(torch, imported, icfg.dtype)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        fid_sweep.main(["--trial", imported] + SWEEP_ARGS)
        out["sweep"]["second_sweep_s"] = time.perf_counter() - t0
        require(not any(K.launch_counts().values()),
                f"the second sweep launched {K.launch_counts()}")
        require(read_scores(imported) == (out["sweep"]["fid"],
                                          out["sweep"]["kid"]),
                "the second sweep rescored")
        emit({"phase": "eval_sweep", **out["sweep"]})
        out["sweep_bf16"] = counted_sweep(torch, orig, cfg.dtype)
        emit({"phase": "eval_sweep_bf16", **out["sweep_bf16"]})
        out["profiled"] = profiled_checkpoint(torch, orig)
        emit({"phase": "eval_profiled_checkpoint", "trial": "bf16",
              **out["profiled"]})
        out["kernels"] = eval_kernel_phase(torch, cfg, icfg, params)

        # ---- G's sampling per batch: bf16 (the trial) and f32 (import),
        # at the sweep's batch, beside it and at the serving batch; the
        # device launches of one f32 forward (cuDNN's algorithm by batch)
        rng = torch.Generator(device=DEVICE).manual_seed(2)
        sampling = {}
        for dt in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dt)
            gen = Generator.from_jax_params(c, params, DEVICE)
            fn = make_eval_generate(c, step=c.max_step)
            for b in (48, EVAL_BATCH, 56, SERVE_BATCH):
                z = torch.randn(b, cfg.z_dim, generator=rng, device=DEVICE)
                lab = torch.arange(b, device=DEVICE) % cfg.num_classes
                row = {"device_ms": cuda_ms(torch, lambda: fn(gen, z, lab),
                                            reps=3)}
                if b == EVAL_BATCH:
                    row["to_host_ms"] = wall_ms(torch, lambda: fn(
                        gen, z, lab).float().cpu().numpy(), reps=3)
                if dt == "float32":
                    row["device_launches_per_forward"] = device_launches(
                        torch, lambda: fn(gen, z, lab))
                sampling[f"{dt}_batch{b}"] = row
            del gen
        out["sampling"] = sampling
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not os.path.exists(root), f"{root} left behind")
    return out


def eval_selftest_phase(torch) -> dict:
    """cli/fid_selftest on a random state dict in a temporary file: exit 2
    as unrecognised weights, then the values computed with
    --allow-unverified (exit 0, finite)."""
    import io
    import math
    import shutil
    from pgx_torch.cli import fid_selftest
    from pgx_torch.eval import inception
    root = tempfile.mkdtemp(prefix="pgx_selftest_")
    try:
        path = os.path.join(root, "random_inception.pt")
        torch.save(inception.init_inception(
            torch.Generator().manual_seed(5)), path)
        runs = {}
        for name, extra in (("unrecognised", []),
                            ("allow_unverified", ["--allow-unverified"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = fid_selftest.main(["--weights", path] + extra)
            runs[name] = {"exit_code": rc, "seconds":
                          time.perf_counter() - t0,
                          **json.loads(buf.getvalue().strip()
                                       .splitlines()[-1])}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    u, a = runs["unrecognised"], runs["allow_unverified"]
    require(u["exit_code"] == 2 and u["status"] == "unrecognized_weights",
            f"self-test on random weights: {u}")
    require(a["exit_code"] == 0 and a["status"] == "computed_unverified"
            and all(math.isfinite(a[k]) for k in ("fid_halves",
                                                  "act_mean_abs",
                                                  "act_mean")),
            f"self-test --allow-unverified: {a}")
    return runs


def eval_phase(torch, cfg, dcfg, params) -> dict:
    """Phase 9: evaluation at the flagship's full width."""
    t0 = time.monotonic()
    emit({"phase": "eval_preprocess", **eval_preprocess_phase(torch)})
    emit({"phase": "eval_features", "config": "InceptionV3 (pytorch_fid "
          "FID variant), f32, init_inception(seed 0)",
          **eval_features_phase(torch)})
    swept = eval_sweep_phase(torch, cfg, dcfg, params)
    emit({"phase": "eval_sampling", **swept["sampling"]})
    emit({"phase": "eval_selftest", **eval_selftest_phase(torch),
          "eval_s": time.monotonic() - t0})
    return swept


# ---------------------------------------------------------------------------
# phase 10: the exported generator, the step-indexed store, the ops' cost
# ---------------------------------------------------------------------------

EXPORT_BUCKETS = (1, 8, 64)
EXPORT_SAMPLES = (64, 5, 100)     # a full bucket, padded to 8, chunked
STORE_ITERATIONS = (2, 4)         # the loop stops at 2, resumes to 4
# loads the artifacts with pgx_torch.export alone, samples each request
# size with launch counts from 0 around it, and names the modules it holds
EXPORT_LOADER = r"""
import json, sys, time
import numpy as np
from pgx_torch.export import load_exported
from pgx_torch.ops.kernels import build
root, inputs_path, out_path = sys.argv[1:4]
inputs = np.load(inputs_path)
arrays, runs, load_s = {}, [], {}
for output in ("uint8", "float"):
    t0 = time.perf_counter()
    gen = load_exported(root + "/" + output)
    load_s[output] = time.perf_counter() - t0
    for n in json.loads(sys.argv[4]):
        build.reset_launch_counts()
        img = gen.generate(inputs["z%d" % n], inputs["labels%d" % n])
        runs.append({"output": output, "n": n,
                     "launches": build.launch_counts()})
        arrays["%s%d" % (output, n)] = img
np.savez(out_path, **arrays)
print(json.dumps({"load_s": load_s, "runs": runs, "modules": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "pgx",
                                                  "pgx_torch"))}))
"""


def padded_calls(fn, z, labels, buckets):
    """``fn`` over ``z`` and ``labels`` as the exported loader calls its
    programs: chunks of the largest bucket, each padded with zeros to the
    smallest bucket that holds it."""
    import numpy as np
    outs = []
    for i in range(0, len(z), buckets[-1]):
        zc, lc = z[i:i + buckets[-1]], labels[i:i + buckets[-1]]
        pad = next(b for b in buckets if b >= len(zc)) - len(zc)
        zp = np.concatenate([zc, np.zeros((pad, z.shape[1]), np.float32)])
        lp = np.concatenate([lc, np.zeros((pad,), np.int32)])
        outs.append(fn(zp, lp)[:len(zc)])
    return np.concatenate(outs)


def export_artifact_phase(torch, cfg, params, tmp: str) -> dict:
    """The flagship exported through ``pgx_torch.export.export_trial`` at
    buckets 1, 8, 64 in uint8 and float output (seconds per bucket, bytes),
    loaded and sampled in a fresh interpreter that imports only
    ``pgx_torch.export`` (launches per request, the modules it holds), each
    result against the live forward at the same padded shapes; then the
    artifact's img/s at bucket 64 against the live forward's, in turns."""
    import numpy as np
    from pgx_torch import export as texport
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import make_eval_generate

    trial = os.path.join(tmp, "trial_export")
    write_trial(trial, cfg, params)
    seconds, real_export = [], torch.export.export

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real_export(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    manifests, sizes = {}, {}
    with mock.patch.object(torch.export, "export", timed):
        for output in ("uint8", "float"):
            path = os.path.join(tmp, "artifact", output)
            manifests[output] = texport.export_trial(
                trial, path, output=output, batch_sizes=EXPORT_BUCKETS,
                device=DEVICE)
            sizes[output] = {f: os.path.getsize(os.path.join(path, f))
                             for f in sorted(os.listdir(path))}
    man = manifests["uint8"]
    require((man["resolution"], man["step"], man["alpha"],
             man["platforms"]) == (128, 6, 1.0, [DEVICE]),
            f"export manifest {man}")
    export_s = {o: dict(zip(EXPORT_BUCKETS, seconds[3 * i:3 * i + 3]))
                for i, o in enumerate(("uint8", "float"))}

    rng = np.random.RandomState(11)
    inputs = {}
    for n in EXPORT_SAMPLES:
        inputs[f"z{n}"] = rng.randn(n, cfg.z_dim).astype(np.float32)
        inputs[f"labels{n}"] = rng.randint(0, cfg.num_classes,
                                           n).astype(np.int32)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", EXPORT_LOADER, os.path.join(tmp, "artifact"),
         os.path.join(tmp, "inputs.npz"), os.path.join(tmp, "outputs.npz"),
         json.dumps(EXPORT_SAMPLES)], cwd=tmp, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": here}, timeout=600)
    subprocess_s = time.perf_counter() - t0
    require(child.returncode == 0,
            f"the artifact's loader failed:\n{child.stderr[-3000:]}")
    loaded = json.loads(child.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded["modules"] if m.split(".")[0] in ("jax", "pgx")
           or m.startswith(("pgx_torch.models", "pgx_torch.core",
                            "pgx_torch.train"))]
    require(not bad, f"the loader holds {bad}")
    for run in loaded["runs"]:
        calls = -(-run["n"] // EXPORT_BUCKETS[-1])     # bucket calls
        want = {k: PER_FORWARD.get(k, 0) * calls for k in run["launches"]}
        require(run["launches"] == want,
                f"artifact launches for n={run['n']}: {run['launches']} "
                f"!= {want}")

    # the live forward on the same weights at the same padded shapes
    gen = Generator.from_jax_params(cfg, params, DEVICE)
    diffs = {}
    with np.load(os.path.join(tmp, "outputs.npz")) as got:
        for output in ("uint8", "float"):
            live = make_eval_generate(cfg, step=man["step"],
                                      fading=man["fading"], output=output)

            def fn(z, lab):
                img = live(gen, torch.from_numpy(z).to(DEVICE),
                           torch.from_numpy(lab).to(DEVICE), man["alpha"])
                return img.float().cpu().numpy() if output == "float" \
                    else img.cpu().numpy()
            for n in EXPORT_SAMPLES:
                want = padded_calls(fn, inputs[f"z{n}"], inputs[f"labels{n}"],
                                    EXPORT_BUCKETS)
                art = got[f"{output}{n}"]
                require(art.shape == want.shape == (n, 128, 128, 3)
                        and art.dtype == want.dtype,
                        f"artifact {art.shape} {art.dtype}, live "
                        f"{want.shape} {want.dtype}")
                diffs[f"{output}_n{n}"] = float(np.abs(
                    art.astype(np.float64) - want.astype(np.float64)).max())
    require(all(v == 0.0 for v in diffs.values()),
            f"artifact against the live forward: {diffs}")

    # img/s at bucket 64 on the card, artifact and live forward in turns
    exported = texport.load_exported(os.path.join(tmp, "artifact", "uint8"))
    z = torch.from_numpy(inputs["z64"]).to(DEVICE)
    lab = torch.from_numpy(inputs["labels64"]).to(DEVICE)
    live = make_eval_generate(cfg, step=man["step"], output="uint8")
    program = exported._fns[64]

    def art():
        with torch.inference_mode():
            program(z, lab)
    turns = {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        fn = (lambda: live(gen, z, lab, man["alpha"])) if name == "live" \
            else art
        turns[name].append(cuda_ms(torch, fn, reps=10))
    host = wall_ms(torch, lambda: exported.generate(inputs["z64"],
                                                    inputs["labels64"]))
    ms = {k: statistics.mean(v) for k, v in turns.items()}
    del gen, exported, program
    return {"manifest": man, "export_s": export_s, "bytes": sizes,
            "loader": {"seconds": subprocess_s, "load_s": loaded["load_s"],
                       "modules": loaded["modules"], "runs": loaded["runs"]},
            "max_abs_diff_vs_live": diffs,
            "b64_ms": ms, "b64_ms_turns": turns,
            "img_per_s_b64": {k: SERVE_BATCH / (v / 1e3)
                              for k, v in ms.items()},
            "generate_b64_host_ms": host,
            "generate_b64_host_img_per_s": SERVE_BATCH / (host / 1e3)}


def state_tensors(state) -> dict:
    """Every tensor of a train state, cloned on its device."""
    out = {f"{k}.{n}": t.detach().clone()
           for k in ("g", "d", "g_ema")
           for n, t in state[k].state_dict().items()}
    out.update({f"{k}.{m}.{n}": t.clone() for k in ("opt_g", "opt_d")
                for m in ("mu", "nu") for n, t in state[k][m].items()})
    out.update({f"ada.{n}": t.clone() for n, t in state["ada"].items()})
    return out


def store_phase(torch, cfg, dcfg, tmp: str) -> dict:
    """The flagship's full train state (bf16 step, f32 master weights)
    through the npz backend's synchronous ``*_state.pt`` write and through
    the step-indexed store: how long ``save`` blocks the caller (first and
    second save), how long the background write takes, three training
    steps with a write in flight against three without, a bitwise restore;
    then ``train_loop`` with ``checkpoint_backend='orbax'`` stopped and
    resumed from the store."""
    from pgx_torch import checkpoint as tckpt
    from pgx_torch.checkpoint.step_store import StepStateStore
    from pgx_torch.data import synthetic_dataset
    from pgx_torch.ops import kernels as K
    from pgx_torch.train import (ProperSchedule, TrainConfig,
                                 init_train_state, make_train_step)
    from pgx_torch.train.loop import LoopConfig, train_loop

    g, d, tc, state = new_train_state(cfg, dcfg, "bfloat16")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False)
    real, labels, z, eps = train_batch(torch, g, seed=300)

    def steps(n=3):
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, real, labels, 1.0, z=z, eps=eps)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    steps(1)                       # moments and the EMA move off their init
    want = state_tensors(state)
    path = os.path.join(tmp, "001_state.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tckpt.save_state(path, state)
    npz_backend_s = time.perf_counter() - t0
    store_dir = os.path.join(tmp, "store_trial")
    store = StepStateStore(store_dir)
    out = {"state_bytes": os.path.getsize(path),
           "npz_backend_sync_write_s": npz_backend_s, "saves": []}
    for it in (1, 2):
        t0 = time.perf_counter()
        store.save(it, state)
        blocked = time.perf_counter() - t0
        if it == 1:
            store.wait()
            out["saves"].append({"iteration": it, "blocking_s": blocked,
                                 "background_write_s":
                                 time.perf_counter() - t0 - blocked})
        else:                      # steps while the write is in flight
            during = steps()
            store.wait()
            out["saves"].append({"iteration": it, "blocking_s": blocked,
                                 "save_to_commit_s":
                                 time.perf_counter() - t0,
                                 "step_ms_during_write": during})
    out["step_ms_alone"] = steps()
    store.close()
    _, _, _, other = new_train_state(cfg, dcfg, "bfloat16")
    t0 = time.perf_counter()
    StepStateStore(store_dir).restore(1, other)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    got = state_tensors(other)
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    require(got.keys() == want.keys() and not unequal
            and other["iteration"] == 1,
            f"restore differs from the saved state: {unequal[:5]}")
    out["restore_bitwise_equal"] = True
    out["tensors"] = len(want)
    del state, other, want, got, step

    # the loop: stopped after 2 iterations, resumed from the store to 4
    trial = None
    seen = []
    K.reset_launch_counts()
    for total in STORE_ITERATIONS:
        trial = train_loop(
            cfg, dcfg, TrainConfig(), ProperSchedule(64, TRAIN_BATCH, 6, 6),
            synthetic_dataset(64, 128, 3, cfg.num_classes, seed=3),
            LoopConfig(main_path=os.path.join(tmp, "loop"),
                       batch_size=TRAIN_BATCH, total_iterations=total,
                       sample_every=100, checkpoint_every=2, log_every=1,
                       checkpoint_backend="orbax", snapshot_sources=False,
                       verbose=False),
            resume_dir=trial, device=DEVICE,
            hooks={"on_iteration": lambda i, st, s, m: seen.append(i)})
    torch.cuda.synchronize()
    launches = K.launch_counts()
    committed = sorted(int(n) for n in os.listdir(
        os.path.join(trial, "step_state")))
    states = [n for n in os.listdir(os.path.join(trial, "checkpoint"))
              if n.endswith("_state.pt")]
    require(seen == [0, 1, 2, 3] and committed == [1, 2, 3, 4]
            and not states,
            f"loop with the store: iterations {seen}, committed "
            f"{committed}, state files {states}")
    # four iterations and one sample grid a run (100 images, one forward)
    want = add_counts(add_counts({}, calls_per_iteration(cfg, dcfg,
                                                         TRAIN_STEP), 4),
                      PER_FORWARD, 2)
    want = {k: want.get(k, 0) for k in launches}
    require(launches == want, f"loop launches {launches} != {want}")
    out["loop"] = {"iterations": seen, "committed": committed,
                   "launches": launches}
    return out


def op_route_phase(torch, cfg, dcfg) -> dict:
    """What the op route costs the host: B and A's forward at the serving
    forward's calls (batch 64) and one 128px training iteration, through
    the wrappers as they are (``torch.library`` ops) and with every op
    swapped for a direct call of its launch (the route before the ops), in
    turns: ops, direct, direct, ops."""
    import importlib
    from pgx_torch.ops.kernels import conv_epilogue, epilogue
    from pgx_torch.train import make_train_step
    pn = importlib.import_module("pgx_torch.ops.kernels.pixel_norm_lrelu")

    def direct():
        stack = contextlib.ExitStack()
        for mod, name, fn in (
                (epilogue, "forward_op", epilogue._launch),
                (epilogue, "backward_op", epilogue._launch_backward),
                (epilogue, "second_order_op", epilogue._launch_second_order),
                (epilogue, "tangent_op", epilogue._launch_jvp),
                (pn, "op", pn._launch),
                (conv_epilogue, "op", lambda x, w, b, upn, s, e:
                 conv_epilogue._launch(x, w, b, upn, s, e, emit_r=False)),
                (conv_epilogue, "op_r", lambda x, w, b, s, e:
                 conv_epilogue._launch(x, w, b, True, s, e, emit_r=True))):
            stack.enter_context(mock.patch.object(mod, name, fn))
        return stack

    rng = torch.Generator(device=DEVICE).manual_seed(21)
    x_b = torch.randn(SERVE_BATCH, 4, 4, 512, device=DEVICE,
                      dtype=torch.bfloat16, generator=rng)
    a_in = [(torch.randn(SERVE_BATCH, r, r, c, device=DEVICE,
                         dtype=torch.bfloat16, generator=rng),
             torch.randn(c, device=DEVICE, dtype=torch.bfloat16,
                         generator=rng) * 0.1)
            for r, c in ((64, 256), (128, 128))]
    g, d, tc, state = new_train_state(cfg, dcfg, "bfloat16")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False)
    real, labels, z, eps = train_batch(torch, g, seed=400)

    def iteration():
        step(state, real, labels, 1.0, z=z, eps=eps)

    cases = {"B_b2b_ms": (lambda: pn.pixel_norm_lrelu(x_b, 0.2), 50),
             "A_b2b_ms_per_forward": (lambda: [
                 epilogue.bias_pixelnorm_lrelu(y, b) for y, b in a_in], 20),
             "iteration_128px_ms": (iteration, 5)}
    turns = {k: {"ops": [], "direct": []} for k in cases}
    for route in ("ops", "direct", "direct", "ops"):
        with (direct() if route == "direct" else contextlib.nullcontext()):
            for key, (fn, reps) in cases.items():
                turns[key][route].append(cuda_ms(torch, fn, reps=reps))
    out = {k: {r: statistics.mean(v) for r, v in t.items()}
           for k, t in turns.items()}
    for v in out.values():
        v["ops_minus_direct"] = v["ops"] - v["direct"]
    out["turns"] = turns
    out["per_launch_us"] = {
        "B": 1e3 * out["B_b2b_ms"]["ops_minus_direct"],
        "A": 1e3 * out["A_b2b_ms_per_forward"]["ops_minus_direct"] / 2}
    del state, step
    return out


def export_store_phase(torch, cfg, dcfg, params, served: dict,
                       forward: dict) -> dict:
    """Phase 10: the exported flagship, the step-indexed store and the op
    route's host cost."""
    import shutil
    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="pgx_export_store_")
    try:
        artifact = export_artifact_phase(torch, cfg, params, root)
        artifact["live_img_per_s_phase3"] = {
            "serve_b64_sequential": served["img_per_s_b64_sequential"],
            "forward_b64_float": SERVE_BATCH / (
                forward["bfloat16"]["forward_b64_ms"] / 1e3)}
        emit({"phase": "export_artifact", **artifact})
        torch.cuda.empty_cache()
        store = store_phase(torch, cfg, dcfg, root)
        emit({"phase": "step_store", **store})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not os.path.exists(root), f"{root} left behind")
    torch.cuda.empty_cache()
    route = op_route_phase(torch, cfg, dcfg)
    emit({"phase": "op_route", "per": "bf16: B at [64,4,4,512]; A's two "
          "calls of a batch-64 forward; one 128px iteration at batch 32",
          **route, "export_store_s": time.monotonic() - t0})
    return {"artifact": artifact, "store": store, "route": route}


# ---------------------------------------------------------------------------
# 11. data parallelism: NCCL at world 1, two gloo ranks on the one card
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_RANK_TIMEOUT = 600    # seconds for both ranks together
DDP_BF16_ITERS = 4        # bf16 ADA iterations at world 2 (the first warms)
DDP_F32_VARIANTS = (("reverse", {}, False), ("jvp", {"gp_mode": "jvp"}, False),
                    ("reverse_ada", {}, True),
                    ("jvp_ada", {"gp_mode": "jvp"}, True))
# the world-2 loop: 2 iterations a mini-step at the global batch 32, 64px
# fade + stable (iterations 0-3), then resumed: 128px fade + stable (4-7)
DDP_LOOP_SPLIT, DDP_LOOP_TOTAL = 4, 8
DDP_LOOP_CHECKPOINTS = (1, 4, 5, 8)   # run start, cadence, end; resume start


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ddp_inputs(torch, gcfg, seed: int, ada: bool):
    """One iteration's global inputs on the card from a seed (the same on
    every rank): the real batch of TRAIN_BATCH, labels, z, eps and, with
    ADA, the three draw sources."""
    from pgx_torch.train import draw_augment_sources
    real, labels, z, eps = train_batch(torch, gcfg, seed)
    draws = dict(z=z, eps=eps)
    if ada:
        rng = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        draws["aug_draws"] = draw_augment_sources(rng)
    return real, labels, draws


@contextlib.contextmanager
def counting_collectives(torch):
    """Count the all-reduce calls (each one NCCL or gloo collective) made
    inside the block."""
    import torch.distributed as dist
    seen = {"all_reduce": 0}
    inner = dist.all_reduce

    def counted(*a, **kw):
        seen["all_reduce"] += 1
        return inner(*a, **kw)

    with mock.patch.object(dist, "all_reduce", counted):
        yield seen


def state_leaves(state) -> dict:
    """Every tensor of a train state by name (parameters, Adam moments,
    the controller), for bitwise comparison."""
    out = {}
    for net in ("g", "d", "g_ema"):
        for n, p in state[net].state_dict().items():
            out[f"{net}.{n}"] = p
    for opt in ("opt_g", "opt_d"):
        for m in ("mu", "nu"):
            for n, t in state[opt][m].items():
                out[f"{opt}.{m}.{n}"] = t
    for k, v in state["ada"].items():
        out[f"ada.{k}"] = v
    return out


def ddp_world1_phase(torch, gcfg, dcfg) -> dict:
    """NCCL at world 1 in this process: one bf16 128px flagship iteration
    (batch 32, reverse penalty, learning rate 0) through
    ``make_train_step(process_group=)`` against the group-free iteration
    run twice (cuDNN in its deterministic mode).  The card's own
    arithmetic does not repeat bit for bit: the backward of the
    generator's bilinear upsample and of the label embedding's gather add
    with atomics (torch has no deterministic version of the first).  So
    every tensor (metrics, parameters, Adam moments, the EMA) that the two
    group-free runs give bit for bit must come out bit for bit with the
    group; each of the others (the generator's gradients upstream of those
    atomics, in Adam's moments) within 4x the largest relative spread of
    the two group-free runs over those tensors.  Learning rate 0: Adam at
    beta1 = 0 turns a rounding-size difference of a near-zero gradient
    entry into a +-lr move of its weight, which no spread of two runs
    bounds.  The kernel launches of each run as ``calls_per_iteration``
    gives, the all-reduce calls per iteration, ms per iteration (at the
    default learning rate) of both."""
    import torch.distributed as dist
    from pgx_torch.ops import kernels as K
    from pgx_torch.parallel.distributed import backend_for
    from pgx_torch.train import make_train_step
    dist.init_process_group(backend_for(DEVICE),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        require(dist.get_backend() == "nccl",
                f"backend {dist.get_backend()} for the card")
        runs, out = {}, {}
        for name, group in (("group_free", None),
                            ("group_free_again", None),
                            ("nccl_world_1", dist.group.WORLD)):
            g, d, tc, state = new_train_state(gcfg, dcfg, "bfloat16")
            step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                                   process_group=group)
            step0 = make_train_step(g, d, dataclasses.replace(
                tc, learning_rate=0.0), step=TRAIN_STEP, fading=False,
                process_group=group)
            want = calls_per_iteration(g, d, TRAIN_STEP)
            real, labels, draws = ddp_inputs(torch, g, 900, False)
            # ---- the main path: counts from 0 around the iteration ----
            with counting_collectives(torch) as colls:
                K.reset_launch_counts()
                _, metrics = step0(state, real, labels, 1.0, **draws)
                torch.cuda.synchronize()
                launches = K.launch_counts()
            # ------------------------------------------------------------
            require(launches == want, f"{name}: launches {launches} != "
                                      f"{want}")
            leaves = {f"metric.{k}": v.clone() for k, v in metrics.items()}
            leaves.update({k: v.detach().clone()
                           for k, v in state_leaves(state).items()})
            runs[name] = leaves
            times = []
            for i in range(3):
                real, labels, draws = ddp_inputs(torch, g, 901 + i, False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, real, labels, 1.0, **draws)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            out[name] = {"launches_per_iteration": launches,
                         "all_reduce_calls_per_iteration":
                             colls["all_reduce"],
                         "ms_per_iteration": statistics.median(times)}
            del state, step
            torch.cuda.empty_cache()
        a, a2, nccl = (runs[k] for k in ("group_free", "group_free_again",
                                         "nccl_world_1"))
        repeatable = [k for k in a if torch.equal(a[k], a2[k])]
        differ = [k for k in repeatable if not torch.equal(a[k], nccl[k])]
        require(not differ, f"NCCL world 1 differs from the group-free "
                            f"iteration where it repeats: {differ[:8]} "
                            f"({len(differ)})")
        def rel(x, y):
            scale = max(y.float().abs().max().item(), 1e-30)
            return (x.float() - y.float()).abs().max().item() / scale

        noisy = [k for k in a if k not in repeatable]
        spread = max((rel(a2[k], a[k]) for k in noisy), default=0.0)
        worst = {"rel_err": 0.0, "tensor": None, "spread": spread}
        for k in noisy:
            err = rel(nccl[k], a[k])
            require(err <= 4.0 * spread, f"NCCL world 1 {k}: {err} of its "
                                         f"largest entry, over 4x the "
                                         f"spread {spread}")
            if err >= worst["rel_err"]:
                worst.update(rel_err=err, tensor=k)
        require(out["group_free"]["all_reduce_calls_per_iteration"] == 0
                and out["nccl_world_1"]["all_reduce_calls_per_iteration"]
                > 0, f"all-reduce calls {out}")
        out["tensors"] = len(a)
        out["bitwise_equal_tensors"] = len(repeatable)
        out["not_repeatable_on_the_card"] = sorted(
            set(a) - set(repeatable))
        out["not_repeatable_worst"] = worst
        out["launches"] = out["nccl_world_1"]["launches_per_iteration"]
        return out
    finally:
        torch.backends.cudnn.deterministic = prev
        dist.destroy_process_group()


def ddp_serve_fid_phase(torch, cfg, params) -> dict:
    """``data_parallel=2`` where one card exists: the service raises pgx's
    ValueError; the split-and-gather helper over ``[cuda:0, cuda:0]``
    against the unsplit forward at buckets 1, 8 and 64 (each padded to a
    multiple of 2 as the service pads), bit for bit against the same rows
    forwarded one chunk after the other, and within the serve phase's bf16
    tolerance of the whole batch in one forward (reported: equal bit for
    bit or not); the service itself over the two-device list, its images
    against the one-device service; then the Inception batch split the
    same way (f32, TF32 off), a ragged batch padded."""
    import numpy as np
    from pgx_torch.eval import fid as tfid
    from pgx_torch.models.generator import Generator
    from pgx_torch.ops import kernels as K
    from pgx_torch.parallel import mesh as pmesh
    from pgx_torch.serve import GeneratorService
    from pgx_torch.train.wgan import make_eval_generate
    out = {}
    n = len(pmesh.local_devices(DEVICE))
    refused = None
    try:
        GeneratorService.from_params(cfg, params, step=cfg.max_step,
                                     data_parallel=n + 1, device=DEVICE)
    except ValueError as e:
        refused = str(e)
    require(refused is not None and f"data_parallel={n + 1} but only {n} "
            f"devices" in refused, f"data_parallel={n + 1} on {n} "
            f"device(s): {refused}")
    out["service_refuses"] = refused
    cuda0 = torch.device(DEVICE, 0)
    mesh = pmesh.make_mesh([cuda0, cuda0])
    gen = Generator.from_jax_params(cfg, params, DEVICE)
    fn = make_eval_generate(cfg, step=cfg.max_step, output="float")
    rng = torch.Generator(device=DEVICE).manual_seed(7)
    buckets = {}
    for bucket in (1, 8, 64):
        b = max(bucket, 2)
        z = torch.randn(b, cfg.z_dim, generator=rng, device=DEVICE)
        lab = torch.arange(b, device=DEVICE) % cfg.num_classes
        whole = fn(gen, z, lab).float()
        K.reset_launch_counts()
        split = pmesh.data_parallel_apply(
            mesh, lambda g_, zc, lc: fn(g_, zc, lc), [gen, gen], z,
            lab).float()
        torch.cuda.synchronize()
        launches = K.launch_counts()
        want = {k: 0 for k in launches}
        want.update({k: 2 * v for k, v in PER_FORWARD.items()})
        require(launches == want, f"bucket {bucket}: launches {launches}")
        h = b // 2
        chunks = torch.cat([fn(gen, z[:h], lab[:h]),
                            fn(gen, z[h:], lab[h:])]).float()
        require(torch.equal(split, chunks),
                f"bucket {bucket}: split differs from its chunks")
        err = (split - whole).abs().max().item()
        tol = 0.05 * whole.abs().max().item()
        require(err <= tol, f"bucket {bucket}: split vs whole {err} > {tol}")
        buckets[str(bucket)] = {"padded_batch": b,
                                "bitwise_equal_to_unsplit":
                                    bool(torch.equal(split, whole)),
                                "max_abs_diff_to_unsplit": err, "tol": tol,
                                "launches": launches}
    out["generator_split"] = buckets
    # the service itself, over the two-device list
    with mock.patch.object(pmesh, "local_devices",
                           lambda device="cuda": [cuda0, cuda0]):
        two = GeneratorService.from_params(cfg, params, step=cfg.max_step,
                                           data_parallel=2, device=DEVICE)
    one = GeneratorService.from_params(cfg, params, step=cfg.max_step,
                                       device=DEVICE)
    try:
        zz = np.random.RandomState(8).randn(5, cfg.z_dim).astype(np.float32)
        ll = (np.arange(5) % cfg.num_classes).astype(np.int32)
        a = two.submit(zz, ll).result(120)
        bb = one.submit(zz, ll).result(120)
        diff = np.abs(a.astype(int) - bb.astype(int))
        require(a.shape == (5, 128, 128, 3) and diff.max() <= 1,
                f"data-parallel service images differ by {diff.max()}")
        out["service_uint8_max_diff"] = int(diff.max())
        out["service_uint8_equal_share"] = float((diff == 0).mean())
    finally:
        two.close()
        one.close()
    del gen
    # Inception's batch split
    ext = tfid.make_extractor(device=DEVICE)
    split_ext = tfid.make_extractor(
        {k: v.detach().cpu() for k, v in ext.model.state_dict().items()},
        device=DEVICE, mesh=mesh)
    x = torch.randn(EVAL_BATCH, 299, 299, 3, generator=rng, device=DEVICE)
    fid_rows = {}
    for b in (EVAL_BATCH, 7):
        whole = ext(x[:b])
        got = split_ext(x[:b])
        h = -(-b // 2)
        xp = torch.cat([x[:b], x[b - 1:b].expand(2 * h - b, *x.shape[1:])])
        chunks = np.concatenate([ext(xp[:h]), ext(xp[h:])])[:b]
        require(np.array_equal(got, chunks),
                f"Inception batch {b}: split differs from its chunks")
        err = float(np.abs(got - whole).max())
        tol = 1e-4 * float(np.abs(whole).max())
        require(got.shape == (b, 2048) and err <= tol,
                f"Inception batch {b}: split vs whole {err} > {tol}")
        fid_rows[str(b)] = {"bitwise_equal_to_unsplit":
                            bool(np.array_equal(got, whole)),
                            "max_abs_diff_to_unsplit": err, "tol": tol}
    out["inception_split"] = fid_rows
    return out


def run_ddp_ranks(torch, flag: str = "--ddp-rank", root=None) -> list:
    """The two gloo ranks as subprocesses of this script on the one card
    (``python3 chip_smoke.py --ddp-rank R WORLD PORT DIR``; ``flag``
    ``--tp-rank`` for phase 12), each importing only pgx_torch; their
    reports, by rank.  A rank that fails or outlives the limit fails the
    phase; both are stopped.  ``root``: the caller's directory (kept), else
    a temporary one (deleted)."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    keep = root is not None
    root = root if keep else tempfile.mkdtemp(prefix="pgx_ddp_")
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(DDP_WORLD):
            log = open(os.path.join(root, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag,
                 str(r), str(DDP_WORLD), str(port), root], cwd=here,
                env={**os.environ, "PYTHONPATH": here}, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DDP_RANK_TIMEOUT
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        tails = []
        for r in range(DDP_WORLD):
            with open(os.path.join(root, f"rank{r}.log")) as f:
                tails.append(f.read()[-3000:])
        require(all(p.returncode == 0 for p in procs), "ddp ranks failed: "
                + " | ".join(f"rank {r} rc {p.returncode}: {t}"
                             for r, (p, t) in enumerate(zip(procs, tails))))
        reports = []
        for r in range(DDP_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        return reports
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


def f32_grad_error(got: dict, want: dict, prefix: str) -> dict:
    """The largest error of any gradient tensor relative to its largest
    entry, and the largest mean error relative to its mean magnitude."""
    worst = {"max_err_rel_to_largest_entry": 0.0, "tensor": None,
             "mean_err_rel_to_mean": 0.0}
    for name, w in want.items():
        if not name.startswith(prefix):
            continue
        scale = w.abs().max().item()
        diff = (got[name] - w).abs()
        if scale == 0.0:
            require(diff.max().item() == 0.0, f"{name}: off-graph, nonzero")
            continue
        worst["mean_err_rel_to_mean"] = max(
            worst["mean_err_rel_to_mean"],
            diff.mean().item() / w.abs().mean().item())
        if diff.max().item() / scale >= worst["max_err_rel_to_largest_entry"]:
            worst["max_err_rel_to_largest_entry"] = diff.max().item() / scale
            worst["tensor"] = name
    return worst


def f32_world_1_refs(torch, cfg, dcfg) -> dict:
    """DDP_F32_VARIANTS at world 1 in this process (rank 0; the other rank
    idle): per variant its metrics, D's and G's gradients by name (Adam's
    mu at learning rate 0, copied) and the controller's p."""
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.train import make_train_step
    g1, d1, tc1, ref_state = new_train_state(cfg, dcfg, "float32")
    refs = {}
    for i, (name, kw, ada) in enumerate(DDP_F32_VARIANTS):
        ref_state["ada"] = init_ada_state(ADA_P0, DEVICE)
        aug = (dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig())
               if ada else {})
        step = make_train_step(g1, d1, dataclasses.replace(
            tc1, learning_rate=0.0, **kw), step=TRAIN_STEP, fading=False,
            **aug)
        real, labels, draws = ddp_inputs(torch, g1, 910 + i, ada)
        _, m = step(ref_state, real, labels, 1.0, **draws)
        torch.cuda.synchronize()
        refs[name] = ({k: float(v) for k, v in m.items()},
                      {f"{net}.{n}": t.clone() for net in ("d", "g")
                       for n, t in ref_state[f"opt_{net}"]["mu"].items()},
                      float(ref_state["ada"]["p"]))
    del ref_state
    torch.cuda.empty_cache()
    return refs


def f32_world_1_check(torch, cfg, dcfg, mine: dict, label: str,
                      refs=None) -> dict:
    """DDP_F32_VARIANTS at world 1 (``refs``, else ``f32_world_1_refs``
    here), each against ``mine[name]`` = (metrics, D's and G's gradients
    by name (Adam's mu at learning rate 0), the controller's p) from the
    ranks: metrics within 1e-3 (1e-4 absolute), gradients within 3e-2 of
    each tensor's largest entry and 5e-3 in the mean (the f32 train
    check's yardstick)."""
    if refs is None:
        refs = f32_world_1_refs(torch, cfg, dcfg)
    checks = {}
    for name, _, _ in DDP_F32_VARIANTS:
        ref = refs[name]
        got_m, got_mu, got_p = mine[name]
        worst_metric = 0.0
        for k, v in ref[0].items():
            err = abs(got_m[k] - v)
            require(err <= 1e-4 + 1e-3 * abs(v),
                    f"f32 {name}: metric {k} {label} {got_m[k]} vs "
                    f"world 1 {v}")
            worst_metric = max(worst_metric, err / max(abs(v), 1e-4))
        dg = f32_grad_error(got_mu, ref[1], "d.")
        gg = f32_grad_error(got_mu, ref[1], "g.")
        for what, r in (("D", dg), ("G", gg)):
            require(r["max_err_rel_to_largest_entry"] <= 3e-2
                    and r["mean_err_rel_to_mean"] <= 5e-3,
                    f"f32 {name}: {what} gradients {label} vs world 1 "
                    f"{r}")
        key = label.replace(" ", "_")
        checks[name] = {"metric_max_rel_err": worst_metric,
                        "d": dg, "g": gg, f"ada_p_{key}": got_p,
                        "ada_p_world_1": ref[2],
                        f"metrics_{key}": got_m, "metrics_world_1": ref[0]}
    return {"tol": {"metric_rel": 1e-3, "metric_abs": 1e-4,
                    "grad_max_rel_to_largest": 3e-2,
                    "grad_mean_rel_to_mean": 5e-3},
            "variants": checks}


def ddp_rank_main(argv, work=None) -> int:
    """One gloo rank of the ddp phase (a subprocess of this script);
    ``work`` the phase's rank function (``ddp_rank_work`` when None)."""
    import torch
    import torch.distributed as dist
    from pgx_torch.ops.kernels import build
    rank, world, port, root = int(argv[0]), int(argv[1]), int(argv[2]), \
        argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    build.load_library()
    require(build.build_seconds is None,
            "a rank built the library (the parent builds it first)")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    report = (work or ddp_rank_work)(torch, rank, world, root)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    # both reports are on disk before either rank leaves; then leave
    # without tearing the group down: gloo's teardown can abort (SIGABRT)
    # a rank whose peer has already closed its sockets
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def ddp_rank_work(torch, rank: int, world: int, root: str) -> dict:
    """The rank's part: the f32 check (rank 0 also runs the world-1
    reference), the bf16 run with the replicas checked, the timing, and
    the flagship CLI's loop over the group with a resume."""
    import math
    import torch.distributed as dist
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.models import zoo
    from pgx_torch.ops import kernels as K
    from pgx_torch.parallel.collectives import average_
    from pgx_torch.parallel.distributed import broadcast_obj
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import make_train_step
    group = dist.group.WORLD
    cfg = zoo.conditional_correct_generator(
        z_dim=512, num_classes=10, channel=512, max_step=6, dtype="bfloat16")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    b = TRAIN_BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    launches = {k: 0 for k in K.launch_counts()}
    out = {"rank": rank, "rank_batch": b}

    def add_launches(got):
        for k, v in got.items():
            launches[k] += v

    def variant_step(g, d, tc, kw, ada):
        aug = (dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig())
               if ada else {})
        return make_train_step(g, d, dataclasses.replace(tc, **kw),
                               step=TRAIN_STEP, fading=False,
                               process_group=group, **aug)

    # ---- f32: world 2 against this script's world-1 iteration ---------
    t_phase = time.perf_counter()
    g, d, tc, state = new_train_state(cfg, dcfg, "float32")
    tc0 = dataclasses.replace(tc, learning_rate=0.0)   # mu = the gradient
    mine = {}
    for i, (name, kw, ada) in enumerate(DDP_F32_VARIANTS):
        state["ada"] = init_ada_state(ADA_P0, DEVICE)
        step = variant_step(g, d, tc0, kw, ada)
        real, labels, draws = ddp_inputs(torch, g, 910 + i, ada)
        K.reset_launch_counts()
        _, m = step(state, real[rows], labels[rows], 1.0, **draws)
        torch.cuda.synchronize()
        add_launches(K.launch_counts())
        mine[name] = ({k: float(v) for k, v in m.items()},
                      {f"{net}.{n}": t.clone() for net in ("d", "g")
                       for n, t in state[f"opt_{net}"]["mu"].items()},
                      float(state["ada"]["p"]))
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        out["f32_check"] = f32_world_1_check(torch, cfg, dcfg, mine,
                                             "world 2")
    mine.clear()
    dist.barrier()
    out["f32_s"] = time.perf_counter() - t_phase

    # ---- bf16 ADA iterations at world 2, then the replicas ------------
    g, d, tc, state = new_train_state(cfg, dcfg, "bfloat16")
    state["ada"] = init_ada_state(ADA_P0, DEVICE)
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                           augment_cfg=bgc_config(),
                           ada_cfg=AdaConfig(interval_batches=1),
                           process_group=group)
    want = calls_per_iteration(g, d, TRAIN_STEP, "shear")
    times, ps = [], []
    for i in range(DDP_BF16_ITERS):
        real, labels, draws = ddp_inputs(torch, g, 950 + i, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0 around each iteration ----
        K.reset_launch_counts()
        _, m = step(state, real[rows], labels[rows], 1.0, **draws)
        torch.cuda.synchronize()
        got = K.launch_counts()
        # ------------------------------------------------------------
        times.append(1e3 * (time.perf_counter() - t0))
        require(got == want, f"rank {rank} bf16 iteration {i}: launches "
                             f"{got} != {want}")
        add_launches(got)
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"rank {rank} bf16 metrics {m}")
        ps.append(float(state["ada"]["p"]))
    t0 = time.perf_counter()
    check_replica_consistency(state, label="bf16 state", group=group)
    out["bf16"] = {"launches_per_iteration": want,
                   "ms_per_iteration": statistics.median(times[1:]),
                   "ms_each": times, "ada_p": ps,
                   "replica_check_s": time.perf_counter() - t0,
                   "state_tensors": len(state_leaves(state))}
    # the all-reduce of one step's gradients (D's, then G's), alone
    grads = [[torch.zeros_like(p) for p in state[net].parameters()]
             for net in ("d", "g")]
    ar = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gl in grads:
            average_(gl, group)
        torch.cuda.synchronize()
        ar.append(1e3 * (time.perf_counter() - t0))
    out["bf16"]["all_reduce_ms_per_step"] = statistics.median(ar)
    out["bf16"]["all_reduce_bytes_per_step"] = sum(
        t.numel() * t.element_size() for gl in grads for t in gl)
    del grads
    dist.barrier()
    if rank == 0:
        # world 1 in this process, the other rank idle: the same iteration
        # with no group at the global batch and at the rank's batch
        step1 = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                                augment_cfg=bgc_config(),
                                ada_cfg=AdaConfig(interval_batches=1))
        for label, sl in (("world_1_batch_32", slice(None)),
                          (f"world_1_batch_{b}", rows)):
            ts = []
            for i in range(3):
                real, labels, draws = ddp_inputs(torch, g, 960 + i, True)
                draws["z"], draws["eps"] = draws["z"][sl], draws["eps"][sl]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step1(state, real[sl], labels[sl], 1.0, **draws)
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            out["bf16"][f"{label}_ms_per_iteration"] = statistics.median(
                ts[1:])
    dist.barrier()
    del state, step
    torch.cuda.empty_cache()

    # ---- train_loop over the group, stopped and resumed ---------------
    from pgx_torch.data import synthetic_dataset
    from pgx_torch.train import LoopConfig, ProperSchedule, TrainConfig
    from pgx_torch.train.loop import train_loop
    loop_root = os.path.join(root, f"loop_rank{rank}")
    os.makedirs(loop_root)
    checked = []
    # the flagship CLI's data and schedule: 2 iterations a mini-step
    dataset = synthetic_dataset(n=max(4 * TRAIN_BATCH, 256), size=32,
                                channels=3, num_classes=cfg.num_classes,
                                seed=0)
    schedule = ProperSchedule(2 * TRAIN_BATCH, TRAIN_BATCH,
                              max_step=cfg.max_step, init_step=5)

    def run_loop(total, resume):
        def on_iteration(i, st, state_, metrics):
            if i == total - 1:
                check_replica_consistency(state_, label=f"loop state at "
                                          f"{i + 1}", group=group)
                checked.append(i + 1)
        return train_loop(
            cfg, dcfg, TrainConfig(), schedule, dataset,
            LoopConfig(trial_name="ddp", main_path=loop_root,
                       batch_size=TRAIN_BATCH, sample_every=4,
                       checkpoint_every=4, log_every=2,
                       total_iterations=total, verbose=False),
            resume_dir=resume, augment_cfg=bgc_config(), augment_p=ADA_P0,
            hooks={"on_iteration": on_iteration}, device=DEVICE)

    t0 = time.perf_counter()
    K.reset_launch_counts()
    trial = broadcast_obj(run_loop(DDP_LOOP_SPLIT, None), group)
    # rank 0 alone reads the trial: the others get a path that is not
    run_loop(DDP_LOOP_TOTAL, trial if rank == 0
             else os.path.join(loop_root, "trial_absent"))
    torch.cuda.synchronize()
    loop_l = K.launch_counts()
    add_launches(loop_l)
    g5 = g_calls_per_forward(cfg, 5)
    g6 = g_calls_per_forward(cfg, 6)
    want = {k: (DDP_LOOP_SPLIT * v + (DDP_LOOP_TOTAL - DDP_LOOP_SPLIT)
                * calls_per_iteration(cfg, dcfg, 6, "shear")[k])
            for k, v in calls_per_iteration(cfg, dcfg, 5, "shear").items()}
    if rank == 0:   # the sample grids: one G forward each, rank 0 alone
        for k in g5:
            want[k] += 2 * g5[k] + 2 * g6[k]
    require(loop_l == want, f"rank {rank} loop launches {loop_l} != {want}")
    require(checked == [DDP_LOOP_SPLIT, DDP_LOOP_TOTAL],
            f"rank {rank}: replicas checked at {checked}")
    files = sorted(os.path.relpath(os.path.join(dp, f), loop_root)
                   for dp, _, fs in os.walk(loop_root) for f in fs)
    loop = {"seconds": time.perf_counter() - t0, "launches": loop_l,
            "files_written": len(files),
            "replicas_bitwise_equal_after_iterations": checked}
    if rank == 0:
        loop["trial"] = ddp_check_trial(trial)
    else:
        require(files == [], f"rank {rank} wrote {files[:5]}")
    out["loop"] = loop
    out["launches"] = launches
    return out


def ddp_check_trial(trial: str) -> dict:
    """What rank 0 must have written: finite CSV rows at 2, 4 (64px) and
    6, 8 (128px), timing.json, the checkpoints and grids at
    DDP_LOOP_CHECKPOINTS."""
    import glob
    import math
    (log,) = glob.glob(os.path.join(trial, "train_log_*.txt"))
    with open(log) as f:
        rows = [[float(v) for v in line.split(",")]
                for line in f.read().splitlines()[1:]]
    require([int(r[0]) for r in rows] == [2, 4, 6, 8]
            and all(math.isfinite(v) for r in rows for v in r),
            f"ddp loop CSV {rows}")
    with open(os.path.join(trial, "timing.json")) as f:
        timing = json.load(f)
    require({k: v["resolution"] for k, v in timing.items()}
            == {"2": 64, "4": 64, "6": 128, "8": 128},
            f"ddp loop timing.json {timing}")
    names = set(os.listdir(os.path.join(trial, "checkpoint")))
    samples = set(os.listdir(os.path.join(trial, "sample")))
    for it in DDP_LOOP_CHECKPOINTS:
        for kind in ("g.model", "d.model", "state.pt"):
            require(f"{it:03d}_{kind}" in names,
                    f"ddp loop: no {it:03d}_{kind} in {sorted(names)}")
        require(f"{it:03d}.png" in samples, f"ddp loop: no sample {it}")
    return {"csv": rows, "timing": timing,
            "checkpoints": sorted(names), "samples": sorted(samples)}


def ddp_phase(torch, cfg, dcfg, params) -> dict:
    """Phase 11: NCCL at world 1 in this process, data-parallel serving and
    Inception over a two-device list of the one card, then the two gloo
    ranks.  ``launches`` sums every kernel launch of the phase's main
    paths (the world-1 group iteration, the split forwards, and each
    rank's iterations and loop)."""
    t0 = time.monotonic()
    world1 = ddp_world1_phase(torch, cfg, dcfg)
    emit({"phase": "ddp_nccl_world_1", **world1})
    served = ddp_serve_fid_phase(torch, cfg, params)
    emit({"phase": "ddp_serve_fid", **served})
    torch.cuda.empty_cache()
    t_ranks = time.monotonic()
    ranks = run_ddp_ranks(torch)
    ranks_s = time.monotonic() - t_ranks
    launches = dict(world1["launches"])
    for row in served["generator_split"].values():
        for k, v in row["launches"].items():
            launches[k] += v
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    r0, r1 = ranks
    require(r0["bf16"]["launches_per_iteration"]
            == r1["bf16"]["launches_per_iteration"], "ranks' launches")
    out = {"world_1": world1, "serve_fid": served,
           "gloo_world_2": {
               "note": "two gloo ranks sharing one card: collectives go "
                       "through host memory, each rank's kernels share "
                       "the card with the other's",
               "f32_check": r0["f32_check"],
               "ms_per_iteration_by_rank": [r["bf16"]["ms_per_iteration"]
                                            for r in ranks],
               "all_reduce_ms_per_step_by_rank": [
                   r["bf16"]["all_reduce_ms_per_step"] for r in ranks],
               "all_reduce_bytes_per_step": r0["bf16"][
                   "all_reduce_bytes_per_step"],
               "bf16": {f"rank{r['rank']}": r["bf16"] for r in ranks},
               "loop": {f"rank{r['rank']}": r["loop"] for r in ranks},
               "f32_s_by_rank": [r["f32_s"] for r in ranks],
               "ranks_s": ranks_s},
           "launches": launches, "seconds": time.monotonic() - t0}
    return out


# ---------------------------------------------------------------------------
# 12. model parallelism: the train state channel-sharded over two gloo ranks
# ---------------------------------------------------------------------------

TP_BF16_ITERS = 4         # bf16 ADA iterations on the grid (the first warms)
TP_512_ITERS = 4          # the recipe's penalty iteration, then 3 plain ones
# the CLI's loop on the grid: 2 iterations a mini-step at the global batch
# 32, 64px fade + stable (iterations 0-3, cut there), then resumed at model
# 1 in this process: 128px fade + stable (4-7); checkpoints and grids at
# 1, 4 and 5, 8 (DDP_LOOP_CHECKPOINTS), CSV rows at 2, 4, 6, 8
TP_LOOP_ARGS = ["--synthetic", "--channels", "512", "--z-dim", "512",
                "--num-classes", "10", "--max-step", "6", "--init-step", "5",
                "--dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH),
                "--images-per-mini-step", str(2 * TRAIN_BATCH),
                "--ada-p", str(ADA_P0), "--sample-every", "4",
                "--checkpoint-every", "4", "--log-every", "2"]


def tp_collective_costs(torch, mesh, state, reps: int = 5) -> dict:
    """The step's collectives alone, on the sharded state's G and D: the
    gather of both at the top of the step, D's again after its update, the
    reduction of D's and then G's gradients (zeros of the whole shapes).
    Median ms of ``reps`` and the bytes of the whole tensors each moves
    (the form the group's backend picks: gloo all-reduces whole buffers
    through host memory)."""
    import torch.distributed as dist
    from pgx_torch.parallel import tp
    gen, disc = state["g"], state["d"]

    def whole_shape(mod, n, p):
        k = mesh.n_model if n in tp.sharded_names(mod) else 1
        return (*p.shape[:-1], p.shape[-1] * k)

    def nbytes(mods, sharded_only):
        return sum(math.prod(whole_shape(m, n, p)) * p.element_size()
                   for m in mods for n, p in m.named_parameters()
                   if n in tp.sharded_names(m) or not sharded_only)

    def timed(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    def gather(mods):
        blocks = tp.unshard_(mesh, mods)
        for m, b in zip(mods, blocks):
            tp.reshard_(m, b)

    grads = {m: [torch.zeros(whole_shape(m, n, p), dtype=p.dtype,
                             device=p.device)
                 for n, p in m.named_parameters()] for m in (gen, disc)}
    out = {"gather_g_d_ms": timed(lambda: gather((gen, disc))),
           "gather_g_d_bytes": nbytes((gen, disc), True),
           "gather_d_ms": timed(lambda: gather((disc,))),
           "gather_d_bytes": nbytes((disc,), True),
           "reduce_d_ms": timed(lambda: tp.reduce_gradients(
               mesh, (disc,), grads[disc])),
           "reduce_g_ms": timed(lambda: tp.reduce_gradients(
               mesh, (gen,), grads[gen])),
           "reduce_bytes": nbytes((gen, disc), False),
           "backend": dist.get_backend(mesh.model_group)}
    out["per_step_ms"] = (out["gather_g_d_ms"] + out["gather_d_ms"]
                          + out["reduce_d_ms"] + out["reduce_g_ms"])
    out["per_step_bytes"] = (out["gather_g_d_bytes"] + out["gather_d_bytes"]
                             + out["reduce_bytes"])
    return out


TP_SPATIAL_BF16_ITERS = 2   # spatial: the flagship's bf16 ADA iterations
                            # (the first recorded), then one timed apart
TP_SPATIAL_512_ITERS = 2    # spatial: the recipe's penalty iteration and a
                            # plain one (both recorded), then one of each
                            # with the collectives timed


@contextlib.contextmanager
def timing_row_collectives(torch, seen: dict):
    """Every row collective of spatial mode made inside the block, waited
    for before and after: per kind (``halo``: one neighbour exchange;
    ``gather``; ``reduce_scatter``, the gather's backward) its calls, ms
    and bytes: the rows a rank sends its neighbours, the whole images a
    gather returns, the whole gradient a reduce-scatter takes (gloo moves
    ``n_model`` times a halo's rows through host memory)."""
    from pgx_torch.parallel import collectives as coll

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def timed(kind, fn, size):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            row = seen.setdefault(kind, {"calls": 0, "ms": 0.0, "bytes": 0})
            row["calls"] += 1
            row["ms"] += 1e3 * (time.perf_counter() - t0)
            row["bytes"] += size(args, out)
            return out
        return run

    with mock.patch.object(coll, "_exchange", timed(
            "halo", coll._exchange, lambda a, o: nbytes(a[1], a[2]))), \
            mock.patch.object(coll, "_gather_rows", timed(
                "gather", coll._gather_rows, lambda a, o: nbytes(o))), \
            mock.patch.object(coll, "_reduce_scatter_rows", timed(
                "reduce_scatter", coll._reduce_scatter_rows,
                lambda a, o: nbytes(a[1]))):
        yield seen
    seen["per_step_ms"] = sum(r["ms"] for r in seen.values()
                              if isinstance(r, dict))
    seen["per_step_bytes"] = sum(r["bytes"] for r in seen.values()
                                 if isinstance(r, dict))


class RankRuns:
    """A rank's main-path runs: ``run(fn, record)`` counts every launch
    from 0 around ``fn()`` (with ``record``, every kernel call recorded
    too, ``recorded_run``, for the parent to hold against the plain
    versions) and returns its result and launches; ``add`` sums launches
    into ``launches``."""

    def __init__(self, torch):
        from pgx_torch.ops import kernels as K
        self.torch, self.K = torch, K
        self.launches = {k: 0 for k in K.launch_counts()}
        self.recorded = ([], [], [], [])

    def add(self, got: dict) -> None:
        add_counts(self.launches, got)

    def run(self, fn, record: bool):
        if record:
            res, got, _, calls = recorded_run(self.torch, fn)
            for acc, c in zip(self.recorded, calls):
                acc.extend(c)
            return res, got
        self.K.reset_launch_counts()
        res = fn()
        self.torch.cuda.synchronize()
        return res, self.K.launch_counts()


def spatial_f32(torch, mesh, cfg, dcfg, iteration, add_launches) -> dict:
    """DDP_F32_VARIANTS of the f32 flagship at 128px on the spatial grid
    ``mesh`` at learning rate 0, every call recorded: per variant (metrics,
    D's and G's gradients, the controller's p) for the world-1 check."""
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.parallel import tp
    from pgx_torch.train import make_train_step
    place = tp.spatial_batch_sharding(mesh)
    rows = place.batch_rows(TRAIN_BATCH)
    g, d, tc, state = new_train_state(cfg, dcfg, "float32")
    mine = {}
    for i, (name, kw, ada) in enumerate(DDP_F32_VARIANTS):
        state["ada"] = init_ada_state(ADA_P0, DEVICE)
        aug = (dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig())
               if ada else {})
        step = make_train_step(g, d, dataclasses.replace(
            tc, learning_rate=0.0, **kw), step=TRAIN_STEP, fading=False,
            mesh=mesh, **aug)
        real, labels, draws = ddp_inputs(torch, g, 910 + i, ada)
        # ---- the main path: counts from 0 around the iteration ----
        m, got = iteration(lambda: step(
            state, place(real), labels[rows], 1.0, **draws)[1], True)
        # ------------------------------------------------------------
        add_launches(got)
        mine[name] = ({k: float(v) for k, v in m.items()},
                      {f"{net}.{n}": t.clone() for net in ("d", "g")
                       for n, t in state[f"opt_{net}"]["mu"].items()},
                      float(state["ada"]["p"]))
    del state
    torch.cuda.empty_cache()
    return mine


def spatial_bf16(torch, mesh, cfg, dcfg, iteration, add_launches) -> dict:
    """The flagship's bf16 ADA iterations on the spatial grid ``mesh``
    (the first recorded), launches per iteration as world 1's, the state
    the same on every rank bit for bit, then one iteration with the row
    collectives timed (``timing_row_collectives``)."""
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import make_train_step
    place = tp.spatial_batch_sharding(mesh)
    rows = place.batch_rows(TRAIN_BATCH)
    g, d, tc, state = new_train_state(cfg, dcfg, "bfloat16")
    state["ada"] = init_ada_state(ADA_P0, DEVICE)
    want = calls_per_iteration(g, d, TRAIN_STEP, "shear")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                           augment_cfg=bgc_config(),
                           ada_cfg=AdaConfig(interval_batches=1), mesh=mesh)
    times = []
    for i in range(TP_SPATIAL_BF16_ITERS + 1):
        real, labels, draws = ddp_inputs(torch, g, 990 + i, True)
        if i == TP_SPATIAL_BF16_ITERS:
            seen = {}
            with timing_row_collectives(torch, seen):
                step(state, place(real), labels[rows], 1.0, **draws)
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0 around each iteration (the
        # first recorded) ----
        m, got = iteration(lambda: step(
            state, place(real), labels[rows], 1.0, **draws)[1], i == 0)
        # ------------------------------------------------------------
        times.append(1e3 * (time.perf_counter() - t0))
        require(got == want, f"spatial bf16 iteration {i}: launches {got} "
                             f"!= {want}")
        add_launches(got)
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"spatial bf16 metrics {m}")
    check_replica_consistency(state, label="spatial bf16 state",
                              group=mesh.world_group)
    del state, step
    torch.cuda.empty_cache()
    return {"launches_per_iteration": want, "ms_each": times,
            "ms_per_iteration": statistics.median(times[1:]),
            "rows": [rows.start, rows.stop],
            "height_rows": [place.height_rows(cfg.resolution(TRAIN_STEP))
                            .start, place.height_rows(
                                cfg.resolution(TRAIN_STEP)).stop],
            "collectives": seen}


def spatial_512(torch, mesh, iteration, add_launches) -> dict:
    """The 512px recipe (bf16, jvp, gp_every 4, fused_g, ADA) on the
    spatial grid ``mesh``: every rank the whole batch of its data position
    (8 rows at n_data 1), its rows of H; the penalty and a plain iteration
    recorded, launches as world 1's, the peak memory over them, then one
    of each with the row collectives timed."""
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    gcfg5, dcfg5 = recipe_pair("bfloat16")
    place = tp.spatial_batch_sharding(mesh)
    rows5 = place.batch_rows(R512_BATCH)
    _, state5, steps5 = recipe_state(gcfg5, dcfg5, mesh=mesh, gp_mode="jvp")
    want5 = {gp: recipe_launches(state5["g"], dcfg5, "jvp", gp)
             for gp in (True, False)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times5 = []
    for i in range(TP_SPATIAL_512_ITERS):
        gp = i % R512_GP_EVERY == 0
        real, labels, draws = recipe_draws(torch, gcfg5, 970 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0 around each iteration (both
        # recorded) ----
        m, got = iteration(lambda: steps5[gp](
            state5, place(real), labels[rows5], 1.0, **draws)[1], True)
        # ------------------------------------------------------------
        times5.append(1e3 * (time.perf_counter() - t0))
        require(got == want5[gp], f"spatial 512px iteration {i}: launches "
                                  f"{got} != {want5[gp]}")
        add_launches(got)
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"spatial 512px metrics {m}")
    del real, labels, draws, m
    peak = torch.cuda.max_memory_allocated()
    collectives = {}
    for gp, seed in ((True, 980), (False, 981)):
        real, labels, draws = recipe_draws(torch, gcfg5, seed)
        seen = {}
        with timing_row_collectives(torch, seen):
            steps5[gp](state5, place(real), labels[rows5], 1.0, **draws)
        collectives["penalty" if gp else "plain"] = seen
    del real, labels, draws
    check_replica_consistency(state5, label="spatial 512px state",
                              group=mesh.world_group)
    del state5, steps5
    torch.cuda.empty_cache()
    res = gcfg5.resolution(R512_STEP)
    return {"ms_each": times5, "penalty_ms": times5[0],
            "plain_ms": times5[1], "rows": [rows5.start, rows5.stop],
            "height_rows": [place.height_rows(res).start,
                            place.height_rows(res).stop],
            "peak_memory_bytes": peak, "collectives": collectives,
            "launches_per_iteration": {"penalty": want5[True],
                                       "plain": want5[False]}}


def spatial_rank_work(torch, rank: int, world: int, root: str) -> dict:
    """One rank of the (1, world) spatial grid alone
    (``tools/nccl_ranks.py spatial``): the f32 check against world 1 on
    rank 0, the bf16 iterations and the 512px recipe (phase 12 runs the
    same pieces beside the channels mode's)."""
    import torch.distributed as dist
    from pgx_torch.models import zoo
    from pgx_torch.parallel import tp
    cfg = zoo.conditional_correct_generator(
        z_dim=512, num_classes=10, channel=512, max_step=6, dtype="bfloat16")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    mesh = tp.make_mesh_2d(1, world, mode="spatial")
    runs = RankRuns(torch)
    out = {"rank": rank, "grid": [mesh.n_data, mesh.n_model, mesh.d,
                                  mesh.m]}
    mine = spatial_f32(torch, mesh, cfg, dcfg, runs.run, runs.add)
    if rank == 0:
        out["f32_check"] = f32_world_1_check(torch, cfg, dcfg, mine,
                                             f"spatial model {world}")
    mine.clear()
    dist.barrier()
    out["bf16"] = spatial_bf16(torch, mesh, cfg, dcfg, runs.run, runs.add)
    dist.barrier()
    out["r512"] = spatial_512(torch, mesh, runs.run, runs.add)
    out["launches"] = runs.launches
    out["recorded_calls"] = [list(dict.fromkeys(c)) for c in runs.recorded]
    return out


def tp_rank_work(torch, rank: int, world: int, root: str,
                 n_model: int = 0, spatial: bool = True) -> dict:
    """One rank of the (world / n_model, n_model) grid (n_model = world
    unless given): the f32 check (rank 0 also runs the world-1 reference),
    the bf16 ADA iterations with the state checked and the collectives
    timed, the 512px recipe at full width (rank 0 also at world 1, batch 8
    and 4), and the flagship CLI's loop on the grid; with ``spatial`` also
    the spatial mode's f32 check, bf16 iterations and 512px recipe on the
    (1, world) grid (``spatial_f32``, ``spatial_bf16``, ``spatial_512``),
    the f32 ones held against the same world-1 references."""
    import torch.distributed as dist
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.augment import AdaConfig, bgc_config, init_ada_state
    from pgx_torch.cli import common
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    from pgx_torch.models import zoo
    from pgx_torch.ops import kernels as K
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import make_train_step
    n_model = n_model or world
    mesh = tp.make_mesh_2d(world // n_model, n_model)
    require((mesh.n_data, mesh.n_model, mesh.d, mesh.m)
            == (world // n_model, n_model, rank // n_model, rank % n_model),
            f"rank {rank} at {mesh}")
    cfg = zoo.conditional_correct_generator(
        z_dim=512, num_classes=10, channel=512, max_step=6, dtype="bfloat16")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=512, num_classes=10, max_step=6, dtype="bfloat16")
    b = TRAIN_BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {"rank": rank, "rank_batch": b,
           "grid": [mesh.n_data, mesh.n_model, mesh.d, mesh.m]}
    # every run of the main path returns its metrics alone: no name keeps
    # the state alive past its ``del``
    runs = RankRuns(torch)
    iteration, add_launches = runs.run, runs.add
    launches, recorded = runs.launches, runs.recorded

    # ---- f32: model 2 against this script's world-1 iteration ---------
    t_phase = time.perf_counter()
    g, d, tc, state = new_train_state(cfg, dcfg, "float32")
    tp.shard_state(mesh, state)
    mine = {}
    for i, (name, kw, ada) in enumerate(DDP_F32_VARIANTS):
        state["ada"] = init_ada_state(ADA_P0, DEVICE)
        aug = (dict(augment_cfg=bgc_config(), ada_cfg=AdaConfig())
               if ada else {})
        step = make_train_step(g, d, dataclasses.replace(
            tc, learning_rate=0.0, **kw), step=TRAIN_STEP, fading=False,
            mesh=mesh, **aug)
        real, labels, draws = ddp_inputs(torch, g, 910 + i, ada)
        # ---- the main path: counts from 0 around the iteration ----
        m, got = iteration(lambda: step(
            state, real[rows], labels[rows], 1.0, **draws)[1], True)
        add_launches(got)
        # ------------------------------------------------------------
        whole = tp.gather_state(mesh, {k: state[k] for k in
                                       ("g", "d", "opt_g", "opt_d")})
        mine[name] = ({k: float(v) for k, v in m.items()},
                      {f"{net}.{n}": t for net in ("d", "g")
                       for n, t in whole[f"opt_{net}"]["mu"].items()},
                      float(state["ada"]["p"]))
        del whole
    del state
    torch.cuda.empty_cache()
    out["f32_s"] = time.perf_counter() - t_phase
    if spatial:
        # ---- spatial mode, f32: the same variants on the (1, world)
        # spatial grid, the images split over H ----
        t_sp = time.perf_counter()
        smesh = tp.make_mesh_2d(1, world, mode="spatial")
        mine_sp = spatial_f32(torch, smesh, cfg, dcfg, iteration,
                              add_launches)
        out["spatial"] = {"f32_s": time.perf_counter() - t_sp}
    if rank == 0:
        refs = f32_world_1_refs(torch, cfg, dcfg)
        out["f32_check"] = f32_world_1_check(torch, cfg, dcfg, mine,
                                             f"model {n_model}", refs)
        if spatial:
            out["spatial"]["f32_check"] = f32_world_1_check(
                torch, cfg, dcfg, mine_sp, f"spatial model {world}", refs)
        del refs
        torch.cuda.empty_cache()
    mine.clear()
    if spatial:
        mine_sp.clear()
    dist.barrier()

    # ---- bf16 ADA iterations on the grid, the state, the collectives ---
    g, d, tc, state = new_train_state(cfg, dcfg, "bfloat16")
    state["ada"] = init_ada_state(ADA_P0, DEVICE)
    want = calls_per_iteration(g, d, TRAIN_STEP, "shear")
    whole_shapes = {k: tuple(v.shape) for k, v in
                    ckpt.state_payload(state)["g"].items()}
    whole_bytes = tp.resident_bytes(state)
    tp.shard_state(mesh, state)
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False,
                           augment_cfg=bgc_config(),
                           ada_cfg=AdaConfig(interval_batches=1), mesh=mesh)
    times, ps = [], []
    for i in range(TP_BF16_ITERS):
        real, labels, draws = ddp_inputs(torch, g, 950 + i, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0 around each iteration (the
        # first, out of the median, recorded) ----
        m, got = iteration(lambda: step(
            state, real[rows], labels[rows], 1.0, **draws)[1], i == 0)
        # ------------------------------------------------------------
        times.append(1e3 * (time.perf_counter() - t0))
        require(got == want, f"rank {rank} bf16 iteration {i}: launches "
                             f"{got} != {want}")
        add_launches(got)
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"rank {rank} bf16 metrics {m}")
        ps.append(float(state["ada"]["p"]))
    t0 = time.perf_counter()
    check_replica_consistency(state, label="bf16 state", mesh=mesh)
    out["bf16"] = {"launches_per_iteration": want,
                   "ms_per_iteration": statistics.median(times[1:]),
                   "ms_each": times, "ada_p": ps,
                   "state_check_s": time.perf_counter() - t0,
                   "state_bytes_whole": whole_bytes,
                   "state_bytes_at_rest": tp.resident_bytes(state),
                   "collectives": tp_collective_costs(torch, mesh, state)}
    del state, step
    torch.cuda.empty_cache()
    dist.barrier()

    # ---- the 512px recipe at full width on the grid ------------------
    gcfg5, dcfg5 = recipe_pair("bfloat16")
    b5 = R512_BATCH // world
    rows5 = slice(rank * b5, (rank + 1) * b5)
    base5 = allocated_at_rest(torch)
    _, state5, steps5 = recipe_state(gcfg5, dcfg5, mesh=mesh,
                                     gp_mode="jvp")
    want5 = {gp: recipe_launches(state5["g"], dcfg5, "jvp", gp)
             for gp in (True, False)}
    whole5 = tp.resident_bytes(state5)
    tp.shard_state(mesh, state5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times5 = []
    for i in range(TP_512_ITERS):
        gp = i % R512_GP_EVERY == 0
        real, labels, draws = recipe_draws(torch, gcfg5, 970 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0 around each iteration (the
        # penalty one and the first plain one recorded) ----
        m, got = iteration(lambda: steps5[gp](
            state5, real[rows5], labels[rows5], 1.0, **draws)[1], i < 2)
        # ------------------------------------------------------------
        times5.append(1e3 * (time.perf_counter() - t0))
        require(got == want5[gp], f"rank {rank} 512px iteration {i}: "
                                  f"launches {got} != {want5[gp]}")
        add_launches(got)
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"rank {rank} 512px metrics {m}")
    del real, labels, draws, m
    r512 = {"ms_each": times5, "penalty_ms": times5[0],
            "plain_ms_median": statistics.median(times5[1:]),
            "state_bytes_whole": whole5,
            "state_bytes_at_rest": tp.resident_bytes(state5),
            "allocated_at_rest": allocated_at_rest(torch) - base5,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_iteration": {"penalty": want5[True],
                                       "plain": want5[False]}}
    check_replica_consistency(state5, label="512px state", mesh=mesh)
    del state5, steps5
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        # world 1 in this process, the other rank idle
        for batch in (R512_BATCH, R512_BATCH // world):
            base1 = allocated_at_rest(torch)
            _, st1, steps1 = recipe_state(gcfg5, dcfg5, gp_mode="jvp")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ts = []
            for i in range(TP_512_ITERS):
                real, labels, draws = recipe_draws(torch, gcfg5, 970 + i,
                                                   batch=batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps1[i % R512_GP_EVERY == 0](st1, real, labels, 1.0,
                                               **draws)
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            del real, labels, draws
            r512[f"world_1_batch_{batch}"] = {
                "ms_each": ts, "plain_ms_median": statistics.median(ts[1:]),
                "state_bytes": tp.resident_bytes(st1),
                "allocated_at_rest": allocated_at_rest(torch) - base1,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            del st1, steps1
            torch.cuda.empty_cache()
    out["r512"] = r512
    dist.barrier()
    if spatial:
        # ---- spatial mode: the flagship's bf16 ADA iterations and the
        # 512px recipe with the whole batch on every rank ----
        t_sp = time.perf_counter()
        out["spatial"]["bf16"] = spatial_bf16(torch, smesh, cfg, dcfg,
                                              iteration, add_launches)
        dist.barrier()
        out["spatial"]["r512"] = spatial_512(torch, smesh, iteration,
                                             add_launches)
        out["spatial"]["bf16_512_s"] = time.perf_counter() - t_sp
        dist.barrier()

    # ---- the flagship CLI's loop at model 2, cut at 4 iterations -----
    loop_root = os.path.join(root, f"loop_rank{rank}")
    os.makedirs(loop_root)
    last_gather = {}
    gather_state = tp.gather_state
    loop_config = common.loop_config_from_args

    def recorded_gather(mesh_, state_):
        whole = gather_state(mesh_, state_)
        if rank == 0 and "opt_g" in whole:
            last_gather.clear()
            last_gather.update(
                {k: v.detach().cpu() for k, v in flat_payload(
                    ckpt.state_payload(whole)).items()
                 if isinstance(v, torch.Tensor)})
        return whole

    def cut(args, **extra):
        return dataclasses.replace(loop_config(args, **extra),
                                   total_iterations=DDP_LOOP_SPLIT)

    t0 = time.perf_counter()
    with mock.patch.object(tp, "gather_state", recorded_gather), \
            mock.patch.object(common, "loop_config_from_args", cut):
        # ---- the main path: counts from 0 around the CLI run ----
        K.reset_launch_counts()
        trial = cli.main(TP_LOOP_ARGS + ["--model-parallel", str(n_model),
                                         "--output", loop_root])
        torch.cuda.synchronize()
        loop_l = K.launch_counts()
        # ----------------------------------------------------------
    add_launches(loop_l)
    want = {k: DDP_LOOP_SPLIT * v for k, v in
            calls_per_iteration(cfg, dcfg, 5, "shear").items()}
    if rank == 0:   # the grids at 1 and 4: one G forward each
        for k, v in g_calls_per_forward(cfg, 5).items():
            want[k] += 2 * v
    require(loop_l == want, f"rank {rank} loop launches {loop_l} != {want}")
    files = sorted(os.path.relpath(os.path.join(dp, f), loop_root)
                   for dp, _, fs in os.walk(loop_root) for f in fs)
    loop = {"seconds": time.perf_counter() - t0, "launches": loop_l,
            "files_written": len(files)}
    if rank == 0:
        saved = flat_payload(torch.load(os.path.join(
            trial, "checkpoint", f"{DDP_LOOP_SPLIT:03d}_state.pt"),
            map_location="cpu", weights_only=True))
        tensors = {k: v for k, v in saved.items()
                   if isinstance(v, torch.Tensor)}
        require(tensors.keys() == last_gather.keys(),
                "checkpoint keys != the gathered state's")
        require(all(torch.equal(tensors[k], last_gather[k])
                    for k in tensors), "checkpoint != the gathered state")
        require(all(tuple(tensors[f"g.{k}"].shape) == v
                    for k, v in whole_shapes.items()),
                "the checkpoint's G is not whole")
        loop["trial"] = trial
        loop["checkpoint_tensors_equal_gathered"] = len(tensors)
    else:
        require(files == [], f"rank {rank} wrote {files[:5]}")
    out["loop"] = loop
    out["launches"] = launches
    out["recorded_calls"] = [list(dict.fromkeys(c)) for c in recorded]
    return out


def allocated_at_rest(torch) -> int:
    """The card allocator's reading with nothing of a step alive: garbage
    collected, the card idle, the cache emptied."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def as_call(x):
    """A recorded call back from JSON: its lists as tuples again."""
    return tuple(as_call(v) for v in x) if isinstance(x, list) else x


def flat_payload(tree, prefix: str = "") -> dict:
    """A nested dict (a ``state_payload``) flattened to ``{'a.b': leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_payload(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def tp_phase(torch, cfg, dcfg) -> dict:
    """Phase 12: the two gloo ranks of the (1, 2) grid, then the ranks'
    trial resumed at model 1 in this process to 128px.  ``launches`` sums
    every kernel launch of the phase's main paths (each rank's iterations
    and loop, and the resumed run).  The calls of the ranks' recorded
    iterations are held against the plain versions here (``hold``), and
    the allocator's readings at rest are held against world 1's."""
    import shutil
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    from pgx_torch.ops import kernels as K
    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="pgx_tp_")
    try:
        torch.cuda.empty_cache()
        ranks = run_ddp_ranks(torch, "--tp-rank", root)
        ranks_s = time.monotonic() - t0
        r0, r1 = ranks
        # ---- the main path: counts from 0 around the resumed run ----
        K.reset_launch_counts()
        t_resume = time.perf_counter()
        trial = cli.main(TP_LOOP_ARGS + ["--output", os.path.join(
            root, "resume"), "--resume", r0["loop"]["trial"]])
        torch.cuda.synchronize()
        resume_l = K.launch_counts()
        # ----------------------------------------------------------
        resume_s = time.perf_counter() - t_resume
        want = {k: (DDP_LOOP_TOTAL - DDP_LOOP_SPLIT) * v for k, v in
                calls_per_iteration(cfg, dcfg, 6, "shear").items()}
        for k, v in g_calls_per_forward(cfg, 6).items():   # grids at 5, 8
            want[k] += 2 * v
        require(resume_l == want, f"resumed loop launches {resume_l} != "
                                  f"{want}")
        require(trial == r0["loop"]["trial"], f"resumed into {trial}")
        resumed = ddp_check_trial(trial)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(resume_l)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    require(r0["bf16"]["launches_per_iteration"]
            == r1["bf16"]["launches_per_iteration"], "ranks' launches")
    # every call the ranks' recorded iterations made (each f32 variant,
    # the first bf16 ADA iteration, the 512px penalty and plain ones),
    # held here against the plain versions unless a phase held it already
    recorded = [list(dict.fromkeys(as_call(c) for r in ranks
                                   for c in r["recorded_calls"][j]))
                for j in range(4)]
    held = hold(torch, "tp: a model-2 rank's rows (the flagship at 16, "
                       "the 512px recipe at 4; spatial: every row, half "
                       "of H, kernel C on haloed tiles)", recorded)
    # the allocator at rest: model 2 holds about half the sharded bytes
    # fewer than world 1 at the same rows
    w1 = r0["r512"][f"world_1_batch_{R512_BATCH // DDP_WORLD}"]
    memory = {"world_1_allocated_at_rest": w1["allocated_at_rest"]}
    for r in ranks:
        half = r["r512"]["state_bytes_whole"] - r["r512"][
            "state_bytes_at_rest"]
        saved = w1["allocated_at_rest"] - r["r512"]["allocated_at_rest"]
        memory[f"rank{r['rank']}"] = {
            "allocated_at_rest": r["r512"]["allocated_at_rest"],
            "saved_bytes": saved, "half_the_sharded_bytes": half,
            "saved_over_half": saved / half}
        require(abs(saved - half) <= 0.1 * half,
                f"rank {r['rank']}: the allocator at rest holds {saved} "
                f"bytes fewer than world 1's, not about {half} (half the "
                f"sharded bytes): {memory}")
    # spatial mode: each rank's peak over the 512px recipe with the whole
    # batch and half the rows of H, beside world 1's at batch 8 and 4
    w1_8 = r0["r512"][f"world_1_batch_{R512_BATCH}"]["peak_memory_bytes"]
    w1_4 = w1["peak_memory_bytes"]
    spatial = {
        "grid": "(n_data, n_model) = (1, 2), mode 'spatial': the images "
                "split over H, the state whole on both ranks",
        "f32_check": r0["spatial"]["f32_check"],
        "bf16": {f"rank{r['rank']}": r["spatial"]["bf16"] for r in ranks},
        "r512": {f"rank{r['rank']}": r["spatial"]["r512"] for r in ranks},
        "r512_peak_memory_bytes": {
            **{f"rank{r['rank']}": r["spatial"]["r512"]["peak_memory_bytes"]
               for r in ranks},
            f"world_1_batch_{R512_BATCH}": w1_8,
            f"world_1_batch_{R512_BATCH // DDP_WORLD}": w1_4},
        "seconds_by_rank": [r["spatial"]["f32_s"]
                            + r["spatial"]["bf16_512_s"] for r in ranks]}
    for r in ranks:
        peak = r["spatial"]["r512"]["peak_memory_bytes"]
        require(peak < w1_8, f"rank {r['rank']}: the spatial 512px peak "
                             f"{peak} is not under world 1's at batch "
                             f"{R512_BATCH} ({w1_8})")
    require(r0["spatial"]["bf16"]["launches_per_iteration"]
            == r1["spatial"]["bf16"]["launches_per_iteration"],
            "spatial ranks' launches")
    return {
        "grid": "(n_data, n_model) = (1, 2): two gloo ranks sharing one "
                "card, collectives through host memory",
        "f32_check": r0["f32_check"],
        "spatial": spatial,
        "bf16": {f"rank{r['rank']}": r["bf16"] for r in ranks},
        "ms_per_iteration_by_rank": [r["bf16"]["ms_per_iteration"]
                                     for r in ranks],
        "r512": {f"rank{r['rank']}": r["r512"] for r in ranks},
        "r512_allocated_at_rest": memory,
        "kernels_held": held,
        "loop": {f"rank{r['rank']}": r["loop"] for r in ranks},
        "resumed_at_model_1": {"seconds": resume_s, "launches": resume_l,
                               "csv": resumed["csv"],
                               "checkpoints": resumed["checkpoints"]},
        "f32_s_by_rank": [r["f32_s"] for r in ranks],
        "ranks_s": ranks_s, "launches": launches,
        "seconds": time.monotonic() - t0}


def main() -> int:
    if sys.argv[1:2] == ["--ddp-rank"]:     # a rank of phase 11
        return ddp_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-rank"]:      # a rank of phase 12
        return ddp_rank_main(sys.argv[2:], tp_rank_work)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    from pgx_torch.ops.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.monotonic()

    # 1. build
    t0 = time.monotonic()
    lib = build.load_library()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvcc_seconds": build.build_seconds,
          "ptxas": ptxas_usage(build.ptxas_log()),
          "resident_blocks": {
              f"{dt} C={c}": {
                  A_BWD: lib.pgx_bias_pixelnorm_lrelu_bwd_partials(
                      1 << 40, c, code),
                  A_BWD2: lib.pgx_bias_pixelnorm_lrelu_bwd2_partials(
                      1 << 40, c, code)}
              for dt, code in build.DTYPE_CODES.items()
              for c in (8, 16, 32, 64, 128, 256, 512)}})

    # 2. kernels at the shapes of both main paths, and their gradients
    cfg, dcfg, params, calls = flagship(torch)
    per_kernel = kernel_phase(torch, calls, "bf16 forward, batch 64")
    train_calls, second = record_train_calls(torch, cfg, dcfg)
    per_kernel_train = kernel_phase(
        torch, train_calls, "bf16 training iteration, batch 32", reps=5)
    second_order = second_order_phase(torch, second)
    emit({"phase": "kernel_a_second_order", "per": "one bf16 training "
          "iteration, batch 32", **second_order})
    emit({"phase": "kernel_gradients", **gradient_phase(torch)})
    emit({"phase": "misaligned_inputs", **misaligned_phase(torch)})
    floor = launch_floor_phase(torch, per_kernel[(B, "bfloat16")]["device_ms"])
    emit({"phase": "launch_floor", **floor})
    emit({"phase": "routing", **routing_phase(torch)})

    # 3. serving through the entry points a user calls
    fwd = forward_check(torch, cfg, params)
    emit({"phase": "forward_check", **fwd})
    emit({"phase": "profile", "what": "bf16 forward, batch 64",
          **profile_forward(torch, cfg, params)})
    served = drive_service(torch, cfg, params)
    emit({"phase": "serve", "config": "conditional_correct_generator("
          "z_dim=512, num_classes=10, channel=512, max_step=6), bfloat16, "
          "128px", **served, "total_s": time.monotonic() - t_start})

    # 4. training: the step a user calls, full width, 128px, batch 32
    emit({"phase": "train_f32_check", **train_f32_check(torch, cfg, dcfg)})
    trained = train_phase(torch, cfg, dcfg)
    emit({"phase": "train", "config": "conditional_correct_generator + "
          "conditional_correct_discriminator_wgangp(feat_dim=512, "
          "num_classes=10, max_step=6), step 6 (128px), batch 32, "
          "gp_mode=reverse, gp_every=1", **trained,
          "total_s": time.monotonic() - t_start})

    # 5. ADA and the ops layer: kernels F, D and E
    from pgx_torch.ops.kernels.bias_act import activation_funcs
    shear_calls = record_ada_launches(torch, cfg, dcfg, "shear")
    gather_calls = record_ada_launches(torch, cfg, dcfg, "gather")
    ops_report, ops_calls = ops_layer_phase(torch)
    emit({"phase": "ops_layer", **ops_report})
    fde = fde_phase(torch, shear_calls,
                    "bf16 ADA iteration (shear warp), batch 32")
    fde = fde_phase(torch, gather_calls,
                    "bf16 ADA iteration (gather warp), batch 32", sums=fde)
    fde = fde_phase(torch, [c for c in ops_calls if c[0] == E_],
                    "ops-layer block, batch 32", sums=fde)
    fde_phase(torch, [c for c in ops_calls if c[0] == D_],
              "ops-layer block, batch 32")
    fde_phase(torch, [(F_, shape, json.dumps({"axis": axis}))
                      for shape, axis in (((2, 3, 1088, 1664), 3),
                                          ((2, 3, 1088, 524), 2),
                                          ((2, 3, 2112, 3200), 3),
                                          ((2, 3, 2112, 1036), 2))],
              "the warp's extents at 256px and 512px, batch 2", reps=3)
    w512 = fde_phase(torch, warp_512_calls(), "kernel W at the 512px "
                     "recipe's shapes, batch 8", reps=3)
    fde_phase(torch, gather_extent_calls(torch, 256)
              + gather_extent_calls(torch, 512),
              "the gather warp's resampling at 256px and 512px, batch 1, "
              "forward and backward", reps=3)
    fde_phase(torch, [(E_, OPS_SHAPE, json.dumps(
        {"act": act, "alpha": spec.def_alpha, "gain": spec.def_gain,
         "clamp": clamp, "bias": True}, sort_keys=True))
        for act, spec in activation_funcs.items() for clamp in (-1.0, 1.5)],
        "every activation, with and without clamp", reps=3)
    emit({"phase": "kernel_gradients_fde", **fde_gradient_phase(torch)})
    emit({"phase": "crop_copy", **crop_copy_phase(torch)})
    emit({"phase": "shear_pipe_f32_check",
          **shear_pipe_f32_check(torch, cfg.resolution(TRAIN_STEP))})
    ada = ada_train_phase(torch, cfg, dcfg)
    emit({"phase": "train_ada", "config": "the train phase's flagship pair, "
          "step 6 (128px), batch 32, augment_cfg=bgc_config(), "
          "ada_cfg=AdaConfig()", **ada,
          "total_s": time.monotonic() - t_start})

    # 6. the training loop through the flagship's CLI, SIGTERM and resume
    looped = train_loop_phase(torch, {"train": trained["img_per_s"],
                                      "train_ada": ada["img_per_s"]})
    emit({"phase": "train_loop", **looped,
          "total_s": time.monotonic() - t_start})
    loop_launches = looped["launches"]

    # 7. the remaining entry points: generate, grow_checkpoint,
    # profile_step, augmentation_demo, the seven trainers, create_gif,
    # prepare_data
    t_cli = time.monotonic()
    cli = cli_phase(torch, cfg, dcfg, params)
    cli_launches = cli["launches"]
    emit({"phase": "cli_summary", "launches": cli_launches,
          "seconds": cli["seconds"], "cli_s": time.monotonic() - t_cli,
          "total_s": time.monotonic() - t_start})

    # 8. the 512px production recipe: jvp penalty, windows, remat
    recipe = recipe_phase(torch)

    # 9. evaluation: the sweep through the CLIs, the .model round trip
    swept = eval_phase(torch, cfg, dcfg, params)
    eval_launches = swept["sweep"]["launches"]
    eval_bf16_launches = swept["sweep_bf16"]["launches"]
    eval_kernels = swept["kernels"]
    # 10. the exported flagship, the step-indexed store, the ops' host cost
    exported = export_store_phase(torch, cfg, dcfg, params, served, fwd)
    artifact_launches = {k: sum(r["launches"][k] for r in
                                exported["artifact"]["loader"]["runs"])
                         for k in build.LAUNCHES}
    # 11. data parallelism: NCCL at world 1, the split serving and
    # Inception batches, two gloo ranks on the card
    ddp = ddp_phase(torch, cfg, dcfg, params)
    emit({"phase": "ddp", **ddp, "total_s": time.monotonic() - t_start})
    ddp_launches = ddp["launches"]
    # 12. model parallelism: the state sharded over two gloo ranks
    tp_run = tp_phase(torch, cfg, dcfg)
    emit({"phase": "tp", **tp_run, "total_s": time.monotonic() - t_start})
    tp_launches = tp_run["launches"]
    recipe_launches_ = {k: recipe["cli"]["launches"][k] + sum(
        m[f"launches_{it}_iteration"][k] for m in recipe["bare"].values()
        for it in ("penalty", "plain")) for k in recipe["cli"]["launches"]}

    def summed(agg):
        return {"launches": agg["calls"], "max_abs_err": agg["err"],
                "tol": agg["tol"], "ms": agg["ms"],
                "plain_ms": agg["plain_ms"],
                "bound_ms": max(agg["t_ops"], agg["t_bytes"]),
                "bound_by": ("operations" if agg["t_ops"] > agg["t_bytes"]
                             else "bytes"),
                "cudnn_conv_bias_ms": agg.get("conv_ms") or None}

    kernels = []
    for name in (A, B, C, C_R, A_BWD):
        source, replaces = SOURCES[name]
        # the headline numbers: per serving forward for the kernels the
        # serving path runs, per training iteration for the entry only
        # training runs
        on_serve = (name, "bfloat16") in per_kernel
        head = per_kernel if on_serve else per_kernel_train
        serve_launches = served["launches"].get(name, 0)
        train_launches = trained["launches"][name]
        ada_launches = ada["launches"][name]
        loop_l = loop_launches[name]
        eval_l = eval_launches[name]
        eval_bf16_l = eval_bf16_launches[name]
        require(train_launches > 0 and ada_launches > 0 and loop_l > 0
                and ddp_launches[name] > 0 and tp_launches[name] > 0
                and (serve_launches > 0 or not on_serve)
                and ((eval_l > 0 and eval_bf16_l > 0) or not on_serve),
                f"{name}: not launched on its main path")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": (serve_launches + train_launches + ada_launches
                              + loop_l + recipe_launches_[name] + eval_l
                              + eval_bf16_l + cli_launches[name]
                              + artifact_launches[name]
                              + ddp_launches[name] + tp_launches[name]),
                 "launches_serve": serve_launches,
                 "launches_eval_sweep": eval_l,
                 "launches_eval_sweep_bf16": eval_bf16_l,
                 "launches_train": train_launches,
                 "launches_train_ada": ada_launches,
                 "launches_train_loop": loop_l,
                 "launches_train_512_recipe": recipe_launches_[name],
                 "launches_cli": cli_launches[name],
                 "launches_export_artifact": artifact_launches[name],
                 "launches_ddp": ddp_launches[name],
                 "launches_tp": tp_launches[name],
                 # the launches of one run of the path named in "per": ms,
                 # plain_ms and bound_ms are sums over these
                 "launches_per_path_run": head[(name, "bfloat16")]["calls"],
                 **{k: v for k, v in summed(head[(name, "bfloat16")]).items()
                    if k != "launches"},
                 "library_ms": None,
                 "f32": summed(head[(name, "float32")]),
                 "per": ("one bf16 forward at batch 64 (sum over its calls)"
                         if on_serve else "one bf16 training iteration at "
                         "batch 32 (sum over its calls)"),
                 "train": {"per": "one bf16 training iteration at batch 32 "
                                  "(sum over its calls)",
                           **summed(per_kernel_train[(name, "bfloat16")]),
                           "f32": summed(per_kernel_train[(name,
                                                           "float32")])}}
        # "ms" times back-to-back launches, the wrapper's host time
        # included; "device_ms" the kernel's own time (CUDA graph)
        entry["device_ms"] = head[(name, "bfloat16")]["device_ms"]
        entry["train"]["device_ms"] = per_kernel_train[
            (name, "bfloat16")]["device_ms"]
        if name == B:
            entry["launch_floor_device_ms"] = floor["empty_kernel_device_ms"]
        if name in (A, B, A_BWD):
            # every launch of one 512px jvp penalty iteration (recipe_phase)
            entry["train_512_recipe"] = recipe["a512"][name]
        if name == C_R:
            # every launch of one 512px jvp penalty iteration (recipe_phase)
            entry["train_512_recipe"] = {
                k: v for k, v in recipe["c512"].items()
                if k not in ("per_shape", "seconds")}
        if on_serve:
            # held at the eval paths' sampling shapes (eval_kernel_phase)
            for key, per in (("eval_sweep", "one sampling batch of 50 at "
                              "128px: f32 as the sweep of the imported trial "
                              "runs it, bf16 as the bf16 sweep and the FID "
                              "tick run it (sum over its calls)"),
                             ("eval_fid_tick_other_batches", "the FID ticks' "
                              "other sampling batches, bf16: 128px at 6, "
                              "64px at 50 and 6 (sum over their calls)")):
                agg = eval_kernels["batch50" if key == "eval_sweep"
                                   else "tick_others"]
                entry[key] = {"per": per,
                              **summed(agg[(name, "bfloat16")]),
                              "device_ms": agg[(name, "bfloat16")][
                                  "device_ms"],
                              "f32": summed(agg[(name, "float32")])}
        kernels.append(entry)

    # A's second derivative: launched in the penalty's outer pass of every
    # training iteration, timed at the iteration's recorded calls
    source, replaces = SOURCES[A_BWD2]
    launches = {"launches_train": trained["launches"][A_BWD2],
                "launches_train_ada": ada["launches"][A_BWD2],
                "launches_train_loop": loop_launches[A_BWD2],
                "launches_train_512_recipe": recipe_launches_[A_BWD2],
                "launches_ddp": ddp_launches[A_BWD2],
                "launches_tp": tp_launches[A_BWD2]}
    require(all(v > 0 for v in launches.values()),
            f"{A_BWD2}: not launched on its main path ({launches})")
    launches["launches_cli"] = cli_launches[A_BWD2]
    so = second_order
    kernels.append({
        "name": A_BWD2, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches.values()), **launches,
        "launches_per_path_run": so["calls"], "max_abs_err": so["max_abs_err"],
        "tol": so["tol"], "ms": so["ms"], "device_ms": so["device_ms"],
        "plain_ms": so["plain_ms"], "bound_ms": so["bound_ms"],
        "bound_by": so["bound_by"], "library_ms": None,
        "autograd_through_plain_backward_ms": so["autograd_ms"],
        "f32": {"ms": so["f32"]["ms"], "plain_ms": so["f32"]["plain_ms"],
                "bound_ms": so["f32"]["t_bytes"],
                "max_rel_err": so["f32"]["max_rel_err"]},
        "train_512_recipe": recipe["a512"][A_BWD2],
        "per": "one bf16 training iteration at batch 32 (sum over its "
               "calls)"})

    # A's tangent: launched in the dual forward of every jvp penalty
    # iteration of the 512px recipe, timed at one such iteration's calls
    source, replaces = SOURCES[A_JVP]
    tg = recipe["tangent"]
    launches = {"launches_train_512_recipe": recipe_launches_[A_JVP],
                "launches_ddp": ddp_launches[A_JVP],
                "launches_tp": tp_launches[A_JVP]}
    require(launches["launches_train_512_recipe"] > 0
            and launches["launches_ddp"] > 0 and launches["launches_tp"] > 0
            and recipe["bare"]["reverse"]["launches_penalty_iteration"][
                A_JVP] == 0,
            f"{A_JVP}: launches {launches}, reverse mode "
            f"{recipe['bare']['reverse']['launches_penalty_iteration']}")
    launches["launches_cli"] = cli_launches[A_JVP]
    kernels.append({
        "name": A_JVP, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches.values()),
        **launches, "launches_per_path_run": tg["calls"],
        "max_abs_err": tg["max_abs_err"], "tol": tg["tol"], "ms": tg["ms"],
        "device_ms": tg["device_ms"], "plain_ms": tg["plain_ms"],
        "bound_ms": tg["bound_ms"], "bound_by": tg["bound_by"],
        "library_ms": None,
        "f32": {"ms": tg["f32"]["ms"], "plain_ms": tg["f32"]["plain_ms"],
                "bound_ms": tg["f32"]["t_bytes"],
                "max_rel_err": tg["f32"]["max_rel_err"]},
        "per": "one bf16 jvp penalty iteration of the 512px recipe at batch "
               "8 (sum over its calls)"})

    # F, D, E: launches from the counted runs of their paths (F the shear
    # ADA iterations; D the gather ADA iteration and the ops-layer block; E
    # the ops-layer block); times summed over one run of the path
    gather_launches = ada["gather_iteration"]["launches"]
    for name, per, per_run, launches in (
            (F_, "one bf16 ADA iteration (shear warp) at batch 32: 6 "
                 "forward and 2 backward launches",
             ada["launches_per_iteration"][F_], {
                 "launches_train_ada": ada["launches"][F_],
                 "launches_train_loop": loop_launches[F_],
                 "launches_train_512_recipe": recipe_launches_[F_],
                 "launches_ddp": ddp_launches[F_],
                 "launches_tp": tp_launches[F_]}),
            (D_, "one bf16 ADA iteration (gather warp) at batch 32: 6 "
                 "forward and 2 backward launches", gather_launches[D_], {
                     "launches_train_ada_gather": gather_launches[D_],
                     "launches_ops_layer": ops_report["launches"][D_]}),
            (E_, "the ops-layer block (conv2d_resample -> bias_act lrelu, "
                 "clamp) at [32,128,128,256], bf16",
             ops_report["launches"][E_], {
                 "launches_ops_layer": ops_report["launches"][E_]})):
        source, replaces = SOURCES[name]
        require(all(v > 0 for v in launches.values()),
                f"{name}: not launched on its main path ({launches})")
        # the loop's and the recipe's paths run neither D nor E: 0 for them
        launches.setdefault("launches_train_loop", loop_launches[name])
        launches.setdefault("launches_train_512_recipe",
                            recipe_launches_[name])
        launches.setdefault("launches_ddp", ddp_launches[name])
        launches.setdefault("launches_tp", tp_launches[name])
        launches["launches_cli"] = cli_launches[name]
        agg = fde[(name, "bfloat16")]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(launches.values()),
                 # the launches of one run of the path named in "per": ms,
                 # plain_ms and bound_ms are sums over these
                 **launches, "launches_per_path_run": per_run,
                 **{k: v for k, v in summed(agg).items()
                    if k not in ("launches", "cudnn_conv_bias_ms")},
                 "library_ms": agg["lib_ms"] if agg["lib_calls"] else None,
                 "library_covers_calls": f"{agg['lib_calls']} of "
                                         f"{agg['calls']}",
                 # the kernel's own device time (CUDA graph): "ms" times
                 # back-to-back calls, where the host's launch time shows
                 # for the small ones
                 **({"device_ms": agg["device_ms"]} if name in (D_, F_)
                    else {}),
                 "f32": {k: v for k, v in
                         summed(fde[(name, "float32")]).items()
                         if k != "cudnn_conv_bias_ms"},
                 "per": per}
        if name == F_:
            entry["per_axis"] = {
                f"axis{ax}": {k: v for k, v in summed(
                    fde[(f"{F_}_axis{ax}", "bfloat16")]).items()
                    if k != "cudnn_conv_bias_ms"}
                | {"device_ms": fde[(f"{F_}_axis{ax}", "bfloat16")][
                    "device_ms"]}
                for ax in (3, 2)}
        kernels.append(entry)

    # W: launches from the counted runs of the shear warp's paths; times
    # summed over one 128px ADA iteration's calls, and over the 512px
    # recipe's four calls
    w_per = {W1: "3 forward calls", W2: "3 forward calls",
             W1_T: "1 backward", W2_T: "1 backward"}
    for name in WARP:
        source, replaces = SOURCES[name]
        launches = {"launches_train_ada": ada["launches"][name],
                    "launches_train_loop": loop_launches[name],
                    "launches_train_512_recipe": recipe_launches_[name],
                    "launches_ddp": ddp_launches[name],
                    "launches_tp": tp_launches[name]}
        require(all(v > 0 for v in launches.values()),
                f"{name}: not launched on its main path ({launches})")
        launches["launches_cli"] = cli_launches[name]
        agg = fde[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            **launches,
            "launches_per_path_run": ada["launches_per_iteration"][name],
            **{k: v for k, v in summed(agg).items()
               if k not in ("launches", "cudnn_conv_bias_ms")},
            "device_ms": agg["device_ms"], "library_ms": None,
            "f32": {k: v for k, v in summed(fde[(name, "float32")]).items()
                    if k != "cudnn_conv_bias_ms"},
            "per": f"one bf16 ADA iteration (shear warp) at batch 32: "
                   f"{w_per[name]}; plain_ms: the plain version in f32",
            "train_512_recipe": {
                "per": "one call at the 512px recipe's shapes, batch 8",
                **{dt: {**{k: v for k, v in summed(w512[(name, dt)]).items()
                           if k != "cudnn_conv_bias_ms"},
                        "device_ms": w512[(name, dt)]["device_ms"]}
                   for dt in ("bfloat16", "float32")}}})

    # 13. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    emit({"kernels": kernels})
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
