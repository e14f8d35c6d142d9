#!/usr/bin/env python3
"""Chip smoke test of pgx_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. build   — build the CUDA kernel library from pgx_torch/ops/kernels/csrc.
2. kernels — record the shapes the 128px flagship generator's bf16 forward
   at batch 64 hands each kernel (A bias_pixelnorm_lrelu, B
   pixel_norm_lrelu, C conv3x3_epilogue); at each, hold the kernel against
   its plain PyTorch version in f32 and bf16 (TF32 off) and time kernel,
   plain version and, where one PyTorch call computes the same function,
   that call (CUDA events, median after warmup).
3. serve   — write the full-width flagship (random weights, seed 0) as a
   trial directory, serve it in bf16 through GeneratorService and its HTTP
   front end, check the outputs and that every forward went through A, B
   and C, check the float forward against the plain path, and measure
   img/s at batch 64 and batch-1 latency.
   A torch.profiler pass splits the forward's device time by part.
4. card    — nvidia-smi's name and power limit.

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

SOURCES = {
    "bias_pixelnorm_lrelu": ("pgx_torch/ops/kernels/csrc/epilogue.cu",
                             "pgx/ops/pallas/epilogue.py:97"),
    "pixel_norm_lrelu": ("pgx_torch/ops/kernels/csrc/epilogue.cu",
                         "pgx/ops/pallas/kernels.py:266"),
    "conv3x3_epilogue": ("pgx_torch/ops/kernels/csrc/conv_epilogue.cu",
                         "pgx/ops/pallas/conv_epilogue.py:139"),
}
PER_FORWARD = {"bias_pixelnorm_lrelu": 2, "pixel_norm_lrelu": 1,
               "conv3x3_epilogue": 9}
SERVE_BATCH = 64


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
    """Replace the kernel wrappers where the path calls them (layers for
    A and C, the generator for B) with ``wrap(name, wrapper)``."""
    from pgx_torch.core import layers
    from pgx_torch.models import generator as G
    with contextlib.ExitStack() as stack:
        for mod, name in ((layers, "conv3x3_epilogue"),
                          (layers, "bias_pixelnorm_lrelu"),
                          (G, "pixel_norm_lrelu")):
            stack.enter_context(mock.patch.object(
                mod, name, wrap(name, getattr(mod, name))))
        yield


def plain_versions():
    """The path with the kernels' plain versions (a comparison on the card;
    the port itself has no such switch)."""
    from pgx_torch.ops import kernels as K
    return swap_path_kernels(lambda name, fn: getattr(K, name + "_ref"))


def record_main_path_calls(torch, gen, cfg):
    """The (kernel, shape, options) calls one bf16 forward at batch 64
    makes, in order."""
    calls = []

    def rec(name, fn):
        def wrapped(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            opts = dict(kw)
            opts.update({"slope": a for a in args if isinstance(a, float)})
            calls.append((name, tuple(tensors[0].shape),
                          tuple(tuple(t.shape) for t in tensors[1:]),
                          json.dumps(opts, sort_keys=True)))
            return fn(*args, **kw)
        return wrapped

    with swap_path_kernels(rec):
        z = torch.randn(SERVE_BATCH, cfg.z_dim, device="cuda")
        lab = torch.arange(SERVE_BATCH, device="cuda") % cfg.num_classes
        with torch.inference_mode():
            gen(z, lab, step=cfg.max_step)
        torch.cuda.synchronize()
    return calls


def kernel_phase(torch, calls):
    import math
    from pgx_torch.ops import kernels as K

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(
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
            if name == "conv3x3_epilogue":
                cin, cout = shape[-1], wshapes[0][-1]
                w = randn(3, 3, cin, cout, scale=math.sqrt(2 / (9 * cin)))
                b = randn(cout, scale=0.1)
                kw = {k: v for k, v in opts.items() if k != "slope"}
                kw["slope"] = opts.get("slope", 0.2)
                kern = lambda: K.conv3x3_epilogue(x, w, b, **kw)
                plain = lambda: K.conv3x3_epilogue_ref(x, w, b, **kw)
                m = numel // cin
                ops = 2.0 * m * 9 * cin * cout
                nbytes = (numel + 9 * cin * cout + cout + m * cout) * es
                peak = PEAK_OPS[dt_name]
                w_oihw = w.to(dt).permute(3, 2, 0, 1).contiguous()
                x_nchw = x.permute(0, 3, 1, 2)
                conv_only = lambda: torch.nn.functional.conv2d(
                    x_nchw, w_oihw, b.to(dt), padding=1)
            else:
                c = shape[-1]
                b = randn(c, scale=0.1)
                slope = opts.get("slope", 0.2)
                if name == "bias_pixelnorm_lrelu":
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
                err = (got.float() - want.float()).abs().max().item()
                ref_max = want.float().abs().max().item()
                tol = (bf16_tol(ref_max) if dt_name == "bfloat16"
                       else (1e-4 if name == "conv3x3_epilogue" else 1e-5))
                require(got.shape == want.shape and got.dtype == dt,
                        f"{name} {shape} {dt_name}: shape/dtype mismatch")
                require(math.isfinite(err) and err <= tol,
                        f"{name} {shape} {dt_name}: max abs err {err} > "
                        f"tol {tol}")
                ms = cuda_ms(torch, kern)
                plain_ms = cuda_ms(torch, plain)
                conv_ms = cuda_ms(torch, conv_only) if conv_only else None
            t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "shape": list(shape), "dtype": dt_name,
                   "calls_per_forward": mult, **opts,
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops > t_bytes else "bytes",
                   "cudnn_conv_bias_ms": conv_ms}
            emit({"phase": "kernel_shape", **row})
            agg = per_kernel.setdefault((name, dt_name), {
                "ms": 0.0, "plain_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0,
                "err": 0.0, "tol": 0.0, "conv_ms": 0.0})
            agg["ms"] += mult * ms
            agg["plain_ms"] += mult * plain_ms
            agg["t_ops"] += mult * t_ops
            agg["t_bytes"] += mult * t_bytes
            agg["conv_ms"] += mult * (conv_ms or 0.0)
            if err >= agg["err"]:
                agg["err"], agg["tol"] = err, tol
    return per_kernel


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
    rng = torch.Generator(device="cuda").manual_seed(1)
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg_bf16, dtype=dt)
        gen = Generator.from_jax_params(cfg, params, "cuda")
        fn = make_eval_generate(cfg, step=cfg.max_step, output="float")
        z = torch.randn(8, cfg.z_dim, generator=rng, device="cuda")
        lab = torch.arange(8, device="cuda") % cfg.num_classes
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
                         device="cuda")
        lb = torch.arange(SERVE_BATCH, device="cuda") % cfg.num_classes
        fwd_ms = cuda_ms(torch, lambda: fn(gen, zb, lb), reps=5)
        with plain_versions():
            plain_fwd_ms = cuda_ms(torch, lambda: fn(gen, zb, lb), reps=5)
        out[dt] = {"max_abs_err": err, "mean_abs_err": mean_err,
                   "ref_max_abs": scale, "tol": tol,
                   "forward_b64_ms": fwd_ms,
                   "plain_forward_b64_ms": plain_fwd_ms}
        del gen
    return out


def flagship(torch):
    """The flagship config, its seeded weights and the kernel calls of one
    bf16 forward at batch 64."""
    from pgx_torch.models import zoo
    from pgx_torch.models.generator import Generator, init_generator

    cfg = zoo.conditional_correct_generator(
        z_dim=512, num_classes=10, channel=512, max_step=6,
        dtype="bfloat16")
    params = init_generator(cfg, seed=0)
    calls = record_main_path_calls(
        torch, Generator.from_jax_params(cfg, params, "cuda"), cfg)
    counts = {}
    for c in calls:
        counts[c[0]] = counts.get(c[0], 0) + 1
    require(counts == PER_FORWARD,
            f"kernel calls per forward {counts} != {PER_FORWARD}")
    return cfg, params, calls


def profile_forward(torch, cfg, params, reps: int = 3):
    """Device time of the bf16 batch-64 forward by part (torch.profiler),
    and the host's wall time to issue and finish one forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import make_eval_generate
    gen = Generator.from_jax_params(cfg, params, "cuda")
    fn = make_eval_generate(cfg, step=cfg.max_step, output="uint8")
    z = torch.randn(SERVE_BATCH, cfg.z_dim, device="cuda")
    lab = torch.arange(SERVE_BATCH, device="cuda") % cfg.num_classes
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
    parts = {"kernel C": "conv3x3_mma_kernel", "kernels A+B": "rownorm_kernel",
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
        svc = GeneratorService(trial, device="cuda", max_batch=SERVE_BATCH)
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
                for name, per in PER_FORWARD.items():
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

    # 2. kernels at the main path's shapes
    cfg, params, calls = flagship(torch)
    per_kernel = kernel_phase(torch, calls)

    # 3. serving through the entry points a user calls
    fwd = forward_check(torch, cfg, params)
    emit({"phase": "forward_check", **fwd})
    emit({"phase": "profile", "what": "bf16 forward, batch 64",
          **profile_forward(torch, cfg, params)})
    served = drive_service(torch, cfg, params)
    emit({"phase": "serve", "config": "conditional_correct_generator("
          "z_dim=512, num_classes=10, channel=512, max_step=6), bfloat16, "
          "128px", **served, "total_s": time.monotonic() - t_start})

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        agg, agg32 = per_kernel[(name, "bfloat16")], per_kernel[(name,
                                                                "float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": agg["err"], "tol": agg["tol"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"],
            "bound_ms": max(agg["t_ops"], agg["t_bytes"]),
            "bound_by": ("operations" if agg["t_ops"] > agg["t_bytes"]
                         else "bytes"),
            "library_ms": None,
            "cudnn_conv_bias_ms": agg["conv_ms"] or None,
            "f32": {"max_abs_err": agg32["err"], "tol": agg32["tol"],
                    "ms": agg32["ms"], "plain_ms": agg32["plain_ms"],
                    "bound_ms": max(agg32["t_ops"], agg32["t_bytes"])},
            "per": "one bf16 forward at batch 64 (sum over its calls)"})

    # 4. the card
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
