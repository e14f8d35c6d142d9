"""Build and load the CUDA kernel library (``csrc/*.cu``) on first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in ``build/`` at the
root of the checkout under a name keyed on a hash of the sources, so an edit
rebuilds and an unchanged tree loads the cached file.  A failed compile
raises with nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lib = None
_lib_lock = threading.Lock()
build_seconds = None          # wall time of the build in this process, if any


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source on first use")


def _compile(out_dir: Path, lib_path: Path) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for cmd, _, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs),
           "-lcudart"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib_path)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_float
    lib.pgx_bias_pixelnorm_lrelu.argtypes = [p, p, p, i64, i, i, f, f, p]
    lib.pgx_pixel_norm_lrelu.argtypes = [p, p, i64, i, i, f, f, p]
    # (y, b, g, dy, db_partial, rows, c, dtype, slope, eps, stream)
    lib.pgx_bias_pixelnorm_lrelu_bwd.argtypes = [p, p, p, p, p, i64, i, i, f,
                                                 f, p]
    lib.pgx_bias_pixelnorm_lrelu_bwd_blocks.argtypes = [i64]
    lib.pgx_bias_pixelnorm_lrelu_bwd_blocks.restype = ctypes.c_int
    lib.pgx_conv3x3_epilogue.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f,
                                         f, p]
    # the residual-emitting entry: (x, w, b, out, r, nb, h, wd, cin, cout,
    # dtype, slope, eps, stream); always pixel-normalizes
    lib.pgx_conv3x3_epilogue_r.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           f, f, p]
    # (img, shift, out, b, c, r, n, axis, dtype, stream)
    lib.pgx_shift_1d.argtypes = [p, p, p, i, i, i, i, i, i, p]
    # (x, out, taps, ntaps, outer, len, n_out, inner, up, down, pad0, dtype,
    # stream); taps is a host array of floats
    lib.pgx_upfirdn_1d.argtypes = [p, p, ctypes.POINTER(f), i, i64, i, i, i,
                                   i, i, i, i, p]
    # (x, b, out, n, c, act, alpha, gain, clamp, dtype, stream)
    lib.pgx_bias_act.argtypes = [p, p, p, i64, i, i, f, f, f, i, p]
    for fn in (lib.pgx_bias_pixelnorm_lrelu, lib.pgx_pixel_norm_lrelu,
               lib.pgx_bias_pixelnorm_lrelu_bwd,
               lib.pgx_conv3x3_epilogue, lib.pgx_conv3x3_epilogue_r,
               lib.pgx_shift_1d, lib.pgx_upfirdn_1d, lib.pgx_bias_act):
        fn.restype = ctypes.c_int
    lib.pgx_upfirdn_max_taps.argtypes = []
    lib.pgx_upfirdn_max_taps.restype = ctypes.c_int
    lib.pgx_conv3x3_cout_pad.argtypes = [i]
    lib.pgx_conv3x3_cout_pad.restype = ctypes.c_int
    lib.pgx_error_string.argtypes = [i]
    lib.pgx_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / f"kernels-{_source_hash()}"
        lib_path = out_dir / "libpgx_torch_kernels.so"
        out_dir.mkdir(parents=True, exist_ok=True)
        # one build per checkout: other processes wait on the lock and
        # then load what it built
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                t0 = time.monotonic()
                _compile(out_dir, lib_path)
                build_seconds = time.monotonic() - t0
        _lib = _declare(ctypes.CDLL(str(lib_path)))
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if status != 0:
        msg = _lib.pgx_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg}) at launch")


# ---------------------------------------------------------------------------
# What every wrapper shares: launch counts and input checks
# ---------------------------------------------------------------------------

# kernel name -> launches in this process; a wrapper adds one where it
# launches its kernel and nowhere else.  Kernel C counts its two entries
# apart: "conv3x3_epilogue" is the plain launch, "conv3x3_epilogue_r" the
# differentiated forward that also writes the pixel-norm scale r.  Kernel
# A's backward ("bias_pixelnorm_lrelu_bwd") counts its own launches.  Kernel
# D ("upfirdn2d") counts one launch per 1-D pass, two per separable call.
LAUNCHES = {"bias_pixelnorm_lrelu": 0, "bias_pixelnorm_lrelu_bwd": 0,
            "pixel_norm_lrelu": 0,
            "conv3x3_epilogue": 0, "conv3x3_epilogue_r": 0,
            "shift_1d": 0, "upfirdn2d": 0, "bias_act": 0}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda_input(name: str, t) -> None:
    """Device, type, layout and alignment a kernel's input must have."""
    import torch
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (NHWC) tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def dtype_code(t) -> int:
    return DTYPE_CODES[str(t.dtype).removeprefix("torch.")]


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
