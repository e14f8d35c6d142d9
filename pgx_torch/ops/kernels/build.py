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
    # (y, b, g, ddy, ddb, d_y, d_g, db_partial, rows, c, dtype, slope, eps,
    # stream); ddy, ddb, d_y, d_g and db_partial may be null
    lib.pgx_bias_pixelnorm_lrelu_bwd2.argtypes = [p, p, p, p, p, p, p, p,
                                                  i64, i, i, f, f, p]
    # (y, b, dy, db, dout, rows, c, dtype, slope, eps, stream); db may be
    # null
    lib.pgx_bias_pixelnorm_lrelu_jvp.argtypes = [p, p, p, p, p, i64, i, i, f,
                                                 f, p]
    lib.pgx_bias_pixelnorm_lrelu_bwd_blocks.argtypes = [i64]
    lib.pgx_bias_pixelnorm_lrelu_bwd_blocks.restype = ctypes.c_int
    # (rows, c, dtype)
    lib.pgx_bias_pixelnorm_lrelu_bwd_partials.argtypes = [i64, i, i]
    lib.pgx_bias_pixelnorm_lrelu_bwd_partials.restype = ctypes.c_int
    lib.pgx_conv3x3_epilogue.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f,
                                         f, p]
    # the residual-emitting entry: (x, w, b, out, r, nb, h, wd, cin, cout,
    # dtype, slope, eps, stream); always pixel-normalizes
    lib.pgx_conv3x3_epilogue_r.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           f, f, p]
    # (img, shift, out, b, c, r, n, sb, sc, sr, axis, dtype, unit_in,
    # unit_out, stream)
    lib.pgx_shift_1d.argtypes = [p, p, p, i, i, i, i, i64, i64, i64, i, i, i,
                                 i, p]
    lib.pgx_shift_1d_tile.argtypes = [i]
    lib.pgx_shift_1d_tile.restype = ctypes.c_int
    # (x, out, plan, dtype, stream); plan points at upfirdn2d.py's _PlanC
    lib.pgx_upfirdn2d.argtypes = [p, p, p, i, p]
    # (x, b, out, n, c, act, alpha, gain, clamp, dtype, stream)
    lib.pgx_bias_act.argtypes = [p, p, p, i64, i, i, f, f, f, i, p]
    for fn in (lib.pgx_bias_pixelnorm_lrelu, lib.pgx_pixel_norm_lrelu,
               lib.pgx_bias_pixelnorm_lrelu_bwd,
               lib.pgx_bias_pixelnorm_lrelu_bwd2,
               lib.pgx_bias_pixelnorm_lrelu_jvp,
               lib.pgx_conv3x3_epilogue, lib.pgx_conv3x3_epilogue_r,
               lib.pgx_shift_1d, lib.pgx_upfirdn2d, lib.pgx_bias_act):
        fn.restype = ctypes.c_int
    lib.pgx_upfirdn2d_plan_bytes.argtypes = []
    lib.pgx_upfirdn2d_plan_bytes.restype = ctypes.c_int
    lib.pgx_conv3x3_cout_pad.argtypes = [i]
    lib.pgx_conv3x3_cout_pad.restype = ctypes.c_int
    lib.pgx_noop.argtypes = [p]
    lib.pgx_noop.restype = ctypes.c_int
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
# A's backward ("bias_pixelnorm_lrelu_bwd"), its second derivative
# ("bias_pixelnorm_lrelu_bwd2") and its tangent ("bias_pixelnorm_lrelu_jvp")
# count their own launches.  Kernel D
# ("upfirdn2d") is one launch per call.
LAUNCHES = {"bias_pixelnorm_lrelu": 0, "bias_pixelnorm_lrelu_bwd": 0,
            "bias_pixelnorm_lrelu_bwd2": 0, "bias_pixelnorm_lrelu_jvp": 0,
            "pixel_norm_lrelu": 0,
            "conv3x3_epilogue": 0, "conv3x3_epilogue_r": 0,
            "shift_1d": 0, "upfirdn2d": 0, "bias_act": 0}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def aligned(t):
    """``t`` when its data pointer is 16-byte aligned, else a copy of it in
    fresh (aligned, contiguous) memory.  A view that starts inside its
    storage, such as ``x[1:]`` of a bf16 ``[B, 127, 127, 3]`` batch, is
    copied, not refused; the copy costs one read and one write of ``t``.
    Layout is not changed otherwise: the input check still refuses a
    non-contiguous tensor that is aligned."""
    import torch
    if t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out.copy_(t)


def check_cuda_input(name: str, t, *, rows_strided: bool = False) -> None:
    """Device, type, layout and alignment a kernel's input must have:
    contiguous and 16-byte aligned or, with ``rows_strided`` (kernel F),
    a last-axis stride of 1 and a 4-byte aligned start."""
    import torch
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    if rows_strided:
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: expected a last-axis stride of 1")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: data pointer not 4-byte aligned")
        return
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (NHWC) tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def dtype_code(t) -> int:
    return DTYPE_CODES[str(t.dtype).removeprefix("torch.")]


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
