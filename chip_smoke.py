#!/usr/bin/env python3
"""Chip smoke test of pgx_torch on one CUDA card.

    python3 chip_smoke.py

Every result is a printed line; ``python3 chip_smoke.py | tee FILE`` keeps
them.

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build   — build the CUDA kernel library from pgx_torch/ops/kernels/csrc.
2. kernels — record the shapes the 128px flagship hands each kernel (A
   bias_pixelnorm_lrelu, B pixel_norm_lrelu, C conv3x3_epilogue and C's
   residual-emitting entry conv3x3_epilogue_r, and A's backward
   bias_pixelnorm_lrelu_bwd) in the generator's bf16 forward at batch 64
   and in one bf16 WGAN-GP training iteration at batch 32; at each, hold
   the kernel against its plain PyTorch version in f32 and bf16 (TF32 off;
   for the residual-emitting entry both y and r, for A's backward dy and
   db) and
   time kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA events, median after warmup).  Then hold each
   wrapper's gradients against autograd through its plain version at one
   mid-size shape (kernel A also to second order, gradient-penalty shaped).
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
   backwards and 11 repeats in the penalty's outer pass); then ms per
   iteration, img/s, peak memory and a torch.profiler split of one
   iteration by part, with A's backward and its second derivative as
   labelled ranges.
5. ada     — kernels F (shift_1d), D (upfirdn2d) and E (bias_act): the
   launches of one bf16 ADA iteration at 128px, batch 32, are recorded
   for the shear warp (F) and for the gather warp (D); each kernel is
   held against its plain version there in f32 and bf16 and timed, F also
   at the 256px and 512px extents (batch 2, both axes), E for all nine
   activations with and without clamp at [32,128,128,256]; gradients of
   F and D (their backward launches the kernel) and of E (first and
   second order) against autograd through the plain versions.  Then the
   ops layer through its public functions (conv2d_resample with a
   separable filter -> bias_act) with launch counts from 0; the shear
   pipe in f32 against the same pipe with the plain versions swapped in;
   bf16 ADA iterations of the flagship (bgc policy, adaptive controller,
   shear warp) with launch counts per iteration asserted, finite metrics,
   the controller's state moving as ada_update implies, ms per iteration,
   img/s, peak memory, the pipe's own time and a torch.profiler split;
   and one iteration with the gather warp, which launches kernel D.
6. card    — nvidia-smi's name and power limit.

Prints JSON lines; the last two lines before the final one are the
kernels table and the card, the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

# one H100 SXM (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate,
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
F32_ELEMENTWISE_OPS = 67e12

A, B, C, C_R = ("bias_pixelnorm_lrelu", "pixel_norm_lrelu",
                "conv3x3_epilogue", "conv3x3_epilogue_r")
A_BWD = "bias_pixelnorm_lrelu_bwd"
F_, D_, E_ = "shift_1d", "upfirdn2d", "bias_act"
SOURCES = {
    A: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
        "pgx/ops/pallas/epilogue.py:97"),
    A_BWD: ("pgx_torch/ops/kernels/csrc/epilogue.cu",
            "pgx/ops/pallas/epilogue.py:115-137 (transposed tangent rule)"),
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
}
PER_FORWARD = {A: 2, B: 1, C: 9}
DEVICE = "cuda"           # every phase runs on the card
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


def bf16_tol(ref_max: float) -> float:
    """Two bf16 steps at the largest output magnitude: the kernel rounds
    once, the plain version after each of its stages."""
    import math
    return 2.0 * 2.0 ** (math.floor(math.log2(max(ref_max, 1e-3))) - 7)


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
    call them, F, D, E where the warp and the ops layer call them."""
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
                    (got, got_r), (want, want_r) = got, want
                    # r = 1/rms: compared relatively.  In bf16 the plain
                    # version takes its statistics from a conv output
                    # already rounded to bf16 (2^-9 relative per term)
                    r_tol = 4e-3 if dt_name == "bfloat16" else 1e-4
                    r_err = ((got_r - want_r.float()).abs()
                             / want_r.float()).max().item()
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
                plain_ms = cuda_ms(torch, plain, reps)
                conv_ms = (cuda_ms(torch, conv_only, reps) if conv_only
                           else None)
            t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            rate = ({"tflop_per_s": ops / ms / 1e9} if name in (C, C_R)
                    else {})
            row = {"kernel": name, "shape": list(shape), "dtype": dt_name,
                   "calls": mult, "per": per, **opts, **rate,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "cudnn_conv_bias_ms": conv_ms}
            if r_err is not None:
                row.update(r_max_rel_err=r_err, r_tol=r_tol)
            if db_err is not None:
                row.update(db_max_rel_err=db_err, db_tol=1e-5)
            emit({"phase": "kernel_shape", **row})
            agg = per_kernel.setdefault((name, dt_name), {
                "ms": 0.0, "plain_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0,
                "err": 0.0, "tol": 0.0, "conv_ms": 0.0, "calls": 0})
            agg["ms"] += mult * ms
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


def calls_per_iteration(gcfg, dcfg, step: int, warp=None) -> dict:
    """Kernel launches of one training iteration, from the configs: four
    discriminator forwards (real, fake, x_hat; the G step's) of two convs
    per stage, each conv followed by kernel A, never kernel C; two
    generator forwards, the D step's without grad (C's plain entry) and
    the G step's under grad (C's residual-emitting entry).  With ADA the
    pipe runs three times (reals, the D step's fakes, the G step's fakes)
    and the G step differentiates its call: the shear warp launches F
    twice per call and twice in the backward (8); the gather warp launches
    D twice per upsample2d and twice per downsample2d, forward and
    backward (16).  Kernel E is not on the training path.

    Kernel A's backward runs wherever a first-order backward reaches A:
    the D step's real, fake and x_hat forwards and the G step's D forward
    (d_convs each), the G step's generator forward (g[A]), and once more in
    the penalty's outer pass, which differentiates the inner backward and
    so runs A's backward again for every A of the x_hat forward but the
    last, whose output reaches the score through linear layers only
    (d_convs - 1)."""
    g = g_calls_per_forward(gcfg, step)
    d_convs = sum(2 if (k == 0 or dcfg.block_type == "double") else 1
                  for k in range(dcfg.entry_stage(step) + 1))
    return {A: 4 * d_convs + 2 * g[A],
            A_BWD: 4 * d_convs + g[A] + d_convs - 1,
            B: 2 * g[B], C: g[C], C_R: g[C],
            F_: 8 if warp == "shear" else 0,
            D_: 16 if warp == "gather" else 0, E_: 0}


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


def record_train_calls(torch, gcfg, dcfg):
    """The kernel calls of one bf16 training iteration at batch 32, and
    the (shape, slope) of every call of kernel A's second derivative (the
    gradient penalty's outer pass through A's backward)."""
    from pgx_torch.ops.kernels import epilogue
    from pgx_torch.train import make_train_step
    g, d, tc, state = new_train_state(gcfg, dcfg, "bfloat16")
    step = make_train_step(g, d, tc, step=TRAIN_STEP, fading=False)
    real, labels, z, eps = train_batch(torch, g, seed=100)
    second = []
    inner = epilogue._BiasPixelNormLreluGrad.backward

    def rec_second(ctx, ddy, ddb):
        second.append((tuple(ctx.saved_tensors[0].shape), ctx.slope))
        return inner(ctx, ddy, ddb)

    with mock.patch.object(epilogue._BiasPixelNormLreluGrad, "backward",
                           staticmethod(rec_second)):
        calls = record_calls(
            torch, lambda: step(state, real, labels, 1.0, z=z, eps=eps))
    want = calls_per_iteration(g, d, TRAIN_STEP)
    got = {k: count_calls(calls).get(k, 0) for k in want}
    require(got == want, f"kernel calls per iteration {got} != {want}")
    d_convs = (want[A] - 2 * g_calls_per_forward(g, TRAIN_STEP)[A]) // 4
    require(len(second) == d_convs, f"{len(second)} second-order calls of "
                                    f"{A}, expected {d_convs}")
    return calls, second


def second_order_phase(torch, second, reps: int = 5):
    """Kernel A's second derivative at each recorded call of one bf16
    iteration: the closed form (the Grad Function's backward, as the
    penalty's outer pass runs it) against autograd's backward through the
    plain first-order ops (what the port ran before the backward became a
    kernel), timed over the same inputs; the two agree to two bf16 steps
    at the largest entry (both work in f32 and round once)."""
    from pgx_torch.ops.kernels import epilogue
    rng = torch.Generator(device=DEVICE).manual_seed(29)
    uniq = {}
    for c in second:
        uniq[c] = uniq.get(c, 0) + 1
    out = {"calls": len(second), "closed_form_ms": 0.0, "autograd_ms": 0.0,
           "max_abs_err": 0.0, "per_shape": []}
    for (shape, slope), mult in uniq.items():
        def rand(*sh, scale=1.0):
            return (torch.randn(*sh, generator=rng, device=DEVICE)
                    * scale).to(torch.bfloat16)
        y, gy, u = rand(*shape), rand(*shape), rand(*shape)
        b = torch.randn(shape[-1], generator=rng, device=DEVICE) * 0.1
        ty, tg = (t.clone().requires_grad_(True) for t in (y, gy))
        closed_dy, _ = epilogue._BiasPixelNormLreluGrad.apply(ty, b, tg,
                                                              slope, 1e-8)
        a = (ty + b.to(ty.dtype)).float()
        plain_dy = epilogue.rownorm_lrelu_backward(
            a, tg.float(), slope, 1e-8).to(ty.dtype)

        def closed():
            return torch.autograd.grad(closed_dy, (ty, tg), u,
                                       retain_graph=True)

        def plain():
            return torch.autograd.grad(plain_dy, (ty, tg), u,
                                       retain_graph=True)

        err = max((x.float() - w.float()).abs().max().item()
                  for x, w in zip(closed(), plain()))
        tol = max(bf16_tol(w.float().abs().max().item()) for w in plain())
        require(err <= tol, f"{A} second derivative {shape}: closed form "
                            f"vs autograd {err} > {tol}")
        ms, plain_ms = cuda_ms(torch, closed, reps), cuda_ms(torch, plain,
                                                            reps)
        out["closed_form_ms"] += mult * ms
        out["autograd_ms"] += mult * plain_ms
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["per_shape"].append({"shape": list(shape), "calls": mult,
                                 "closed_form_ms": ms, "autograd_ms": plain_ms,
                                 "max_abs_err": err, "tol": tol})
        del closed_dy, plain_dy, a, ty, tg
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
    repeat in its outer pass) and its closed-form second derivative (the
    penalty's outer pass through the inner backward) are read from
    labelled ranges around them.  The backward kernel has its own part;
    the second derivative's plain ops are part of "elementwise and
    reductions"."""
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
    device_events = [ev for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA
                     and ev.name not in ranges]      # the ranges themselves
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
            and by_part["kernel A backward"] > 0,
            "profiler saw no device time for the iteration, kernel C or "
            "kernel A's backward")
    by_name = {}
    for ev in device_events:
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / 1e3 / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ms_per_iteration": total, "by_part_ms": by_part,
            "top_kernels_ms": [[n[:90], t] for n, t in top],
            "kernel_a_backward_first_order_ms": span["kernel_a_backward"],
            "kernel_a_second_order_ms": span["kernel_a_second_order"],
            "note": "the two kernel_a ranges span the device work launched "
                    "inside them: the first order is mostly 'kernel A "
                    "backward', the second order 'elementwise and "
                    "reductions'"}


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
    require(d_alone == {A: d_convs, A_BWD: 0, B: 0, C: 0, C_R: 0, F_: 0,
                        D_: 0, E_: 0},
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
            "peak_memory_bytes": peak, "profile": prof}


# ---------------------------------------------------------------------------
# phase 5: ADA, the ops layer, kernels F, D and E
# ---------------------------------------------------------------------------

ADA_P0 = 0.6              # the controller's p at the start of the ADA run
OPS_SHAPE = (TRAIN_BATCH, 128, 128, 256)     # a flagship 128px activation


def record_launches(torch, run):
    """Every launch of kernels F, D and E that ``run()`` makes, forward and
    backward alike, as (kernel, input shape, arguments): recorded where the
    wrappers launch (a call of D's is two kernel launches, H pass and W
    pass)."""
    from pgx_torch.ops.kernels import bias_act, shear, upfirdn2d
    calls = []

    def rec(mod, name, describe):
        inner = mod._launch

        def wrapped(x, *args):
            calls.append((name, tuple(x.shape),
                          json.dumps(describe(*args), sort_keys=True)))
            return inner(x, *args)
        return mock.patch.object(mod, "_launch", wrapped)

    with rec(shear, F_, lambda shift, axis: {"axis": axis}), \
            rec(upfirdn2d, D_, lambda taps, up, down, pads, flip: {
                "taps": list(taps), "up": up, "down": down,
                "pads": list(pads), "flip_filter": flip}), \
            rec(bias_act, E_, lambda b, spec, alpha, gain, clamp: {
                "act": next(k for k, v in bias_act.activation_funcs.items()
                            if v is spec),
                "alpha": alpha, "gain": gain, "clamp": clamp,
                "bias": b is not None}):
        run()
        torch.cuda.synchronize()
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
    if name == F_:
        axis = opts["axis"]
        b, _, r, n = shape
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
        # fits one call's arguments: the gather path's two calls
        if (up, down) == (2, 1) and px1 == px0 - 1 and py1 == py0 - 1 \
                and px0 == py0 <= n - 1:
            w2t = w2d.flip(2, 3)
            library = lambda: torch.nn.functional.conv_transpose2d(
                xn, w2t, stride=2, padding=n - 1 - px0, groups=c)
        elif up == 1 and max(pads) <= 0:
            xc = xn[:, :, -py0:h + py1, -px0:w + px1]
            library = lambda: torch.nn.functional.conv2d(
                xc, w2d, stride=down, groups=c)
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


def fde_phase(torch, calls, per: str, reps: int = 5, sums=None):
    """Hold kernels F, D and E against their plain versions at every
    distinct launch of ``calls``, in bf16 and f32, and time kernel, plain
    version and library call.  Tolerance: both sides compute in f32 and
    round once, so f32 agrees to 1e-5 (sums in another order) and bf16 to
    one bf16 step at the largest output.  Adds the sums over the calls by
    (kernel, dtype) to ``sums`` and returns it."""
    import math
    rng = torch.Generator(device=DEVICE).manual_seed(7)
    uniq = {}
    for c in calls:
        uniq[c] = uniq.get(c, 0) + 1
    sums = {} if sums is None else sums
    for (name, shape, opts_s), mult in uniq.items():
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
                tol = (bf16_tol(ref_max) / 2 if dt_name == "bfloat16"
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
                plain_ms = cuda_ms(torch, plain, reps)
                if library is not None:
                    lib_ms = cuda_ms(torch, library, reps)
            t_ops = ops / F32_ELEMENTWISE_OPS * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            small = {k: v for k, v in opts.items() if k != "taps"}
            emit({"phase": "kernel_shape", "kernel": name,
                  "shape": list(shape), "dtype": dt_name, "calls": mult,
                  "per": per, **small, "max_abs_err": err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops > t_bytes else "bytes",
                  "library_ms": lib_ms})
            agg = sums.setdefault((name, dt_name), {
                "ms": 0.0, "plain_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0,
                "err": 0.0, "tol": 0.0, "lib_ms": 0.0, "lib_calls": 0,
                "calls": 0})
            agg["ms"] += mult * ms
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
        require(K.launch_counts()[D_] == before + 4,
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
    want_counts.update({D_: 2, E_: 1})
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
    """The shear pipe through kernel F against the same pipe with the
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
    state["ada"] = init_ada_state(ADA_P0)
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
    """The launches of F, D and E in one bf16 ADA iteration, batch 32."""
    g, d, state, step = new_ada_step(gcfg, dcfg, warp)
    real, labels, draws = ada_batch(torch, g, seed=500)
    calls = record_launches(
        torch, lambda: step(state, real, labels, 1.0, **draws))
    want = calls_per_iteration(g, d, TRAIN_STEP, warp)
    got = count_calls(calls)
    # a recorded call of D's is two kernel launches
    require(got == {k: v for k, v in ((F_, want[F_]), (D_, want[D_] // 2))
                    if v}, f"{warp} ADA iteration recorded {got}")
    return calls


def profile_ada_iteration(torch, run, reps: int = 2):
    """Device time of one bf16 ADA iteration by part (torch.profiler,
    kernels classified by name), with the forward calls of the pipe as a
    labelled range (its backward runs inside autograd's and is not in the
    range; kernel F's launches are counted by name in both)."""
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
    parts = {"kernel F": ("shift_kernel",),
             "kernel C (plain + emit-r)": ("conv3x3_wgmma_kernel",
                                           "conv3x3_fma_kernel"),
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
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3 / reps
        if ev.name == "augment_pipe_forward":
            pipe_ms += ms
            continue
        if any(lo <= ev.time_range.start <= hi for lo, hi in pipe_ranges):
            pipe_kernels += 1
            pipe_busy_ms += ms
        name = ev.name.lower()
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
    require(total > 0 and by_part["kernel F"] > 0 and pipe_ms > 0
            and pipe_kernels > 0,
            "profiler saw no device time for kernel F or the pipe")
    return {"device_ms_per_iteration": total, "by_part_ms": by_part,
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
            "pipe_alone_b32_bf16": {"forward_ms": pipe_fwd_ms,
                                    "forward_backward_ms": pipe_both_ms},
            "profile": prof}


def main() -> int:
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
    build.load_library()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvcc_seconds": build.build_seconds})

    # 2. kernels at the shapes of both main paths, and their gradients
    cfg, dcfg, params, calls = flagship(torch)
    per_kernel = kernel_phase(torch, calls, "bf16 forward, batch 64")
    train_calls, second = record_train_calls(torch, cfg, dcfg)
    per_kernel_train = kernel_phase(
        torch, train_calls, "bf16 training iteration, batch 32", reps=5)
    emit({"phase": "kernel_a_second_order", "per": "one bf16 training "
          "iteration, batch 32", **second_order_phase(torch, second)})
    emit({"phase": "kernel_gradients", **gradient_phase(torch)})

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
    fde_phase(torch, [(E_, OPS_SHAPE, json.dumps(
        {"act": act, "alpha": spec.def_alpha, "gain": spec.def_gain,
         "clamp": clamp, "bias": True}, sort_keys=True))
        for act, spec in activation_funcs.items() for clamp in (-1.0, 1.5)],
        "every activation, with and without clamp", reps=3)
    emit({"phase": "kernel_gradients_fde", **fde_gradient_phase(torch)})
    emit({"phase": "shear_pipe_f32_check",
          **shear_pipe_f32_check(torch, cfg.resolution(TRAIN_STEP))})
    ada = ada_train_phase(torch, cfg, dcfg)
    emit({"phase": "train_ada", "config": "the train phase's flagship pair, "
          "step 6 (128px), batch 32, augment_cfg=bgc_config(), "
          "ada_cfg=AdaConfig()", **ada,
          "total_s": time.monotonic() - t_start})

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
        require(train_launches > 0 and ada_launches > 0
                and (serve_launches > 0 or not on_serve),
                f"{name}: not launched on its main path")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": serve_launches + train_launches + ada_launches,
                 "launches_serve": serve_launches,
                 "launches_train": train_launches,
                 "launches_train_ada": ada_launches,
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
        kernels.append(entry)

    # F, D, E: launches from the counted runs of their paths (F the shear
    # ADA iterations; D the gather ADA iteration and the ops-layer block; E
    # the ops-layer block); times summed over one run of the path
    gather_launches = ada["gather_iteration"]["launches"]
    for name, per, per_run, launches in (
            (F_, "one bf16 ADA iteration (shear warp) at batch 32: 6 "
                 "forward and 2 backward launches",
             ada["launches_per_iteration"][F_], {
                 "launches_train_ada": ada["launches"][F_]}),
            (D_, "one bf16 ADA iteration (gather warp) at batch 32: 12 "
                 "forward and 4 backward launches", gather_launches[D_], {
                     "launches_train_ada_gather": gather_launches[D_],
                     "launches_ops_layer": ops_report["launches"][D_]}),
            (E_, "the ops-layer block (conv2d_resample -> bias_act lrelu, "
                 "clamp) at [32,128,128,256], bf16",
             ops_report["launches"][E_], {
                 "launches_ops_layer": ops_report["launches"][E_]})):
        source, replaces = SOURCES[name]
        require(all(v > 0 for v in launches.values()),
                f"{name}: not launched on its main path ({launches})")
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
                 "f32": {k: v for k, v in
                         summed(fde[(name, "float32")]).items()
                         if k != "cudnn_conv_bias_ms"},
                 "per": per}
        kernels.append(entry)

    # 6. the card
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
