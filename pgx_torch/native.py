"""The C++ host runtime of the data path (counterpart of ``pgx/native.py``).

The port keeps its own copy of pgx's runtime source
(``pgx_torch/runtime/pgx_runtime.cpp``, ABI 2) and builds it at first use:
``g++ -O3 -march=native`` into ``build/native-<digest>/libpgx_runtime.so``
at the root of the checkout (the digest covers the source bytes and the
flags, so an edit rebuilds and an unchanged tree loads the cached file),
under a file lock so that concurrent processes build once, and binds it
with ``ctypes``.  Every entry point keeps pgx's numpy fallback, taken when
no compiler is present, the build fails, or ``PGX_DISABLE_NATIVE`` is set
(pgx's switch); ``native_available()`` says which one runs.  Nothing is
built at import time.
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
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "runtime" / "pgx_runtime.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build"
CFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False
_lock = threading.Lock()
build_seconds: Optional[float] = None   # the build's wall time here, if any
unavailable_reason: Optional[str] = None


def library_path() -> Path:
    """Where this checkout's runtime is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"native-{digest}" / "libpgx_runtime.so"


def _build(so_path: Path) -> None:
    global build_seconds
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH")
    so_path.parent.mkdir(parents=True, exist_ok=True)
    with open(so_path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so_path.exists():
            return
        t0 = time.monotonic()
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CFLAGS, str(SOURCE), "-o", str(tmp)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed: {r.stderr.strip()}")
        os.replace(tmp, so_path)
        build_seconds = time.monotonic() - t0


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every entry's argument and result types (ABI 2)."""
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.normalize_u8_to_f32.argtypes = [u8, i64, f32]
    lib.gather_normalize.argtypes = [u8, ctypes.POINTER(i64), i64, i64, f32]
    lib.resize_bilinear_u8.argtypes = [u8, i64, i64, i64, i64, u8, i64, i64]
    lib.resize_box_u8.argtypes = [u8, i64, i64, i64, i64, u8, i64]
    for fn in (lib.normalize_u8_to_f32, lib.gather_normalize,
               lib.resize_bilinear_u8, lib.resize_box_u8):
        fn.restype = None
    lib.pgx_runtime_abi_version.argtypes = []
    lib.pgx_runtime_abi_version.restype = ctypes.c_int
    return lib


def load_runtime(verbose: bool = False) -> Optional[ctypes.CDLL]:
    """Build (once per checkout) and load the runtime; None when it cannot
    be built, or ``PGX_DISABLE_NATIVE`` is set (the numpy fallbacks run)."""
    global _lib, _lib_checked, unavailable_reason
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        if os.environ.get("PGX_DISABLE_NATIVE"):
            unavailable_reason = "PGX_DISABLE_NATIVE is set"
            return None
        try:
            so_path = library_path()
            if not so_path.exists():
                _build(so_path)
            lib = _declare(ctypes.CDLL(str(so_path)))
            if lib.pgx_runtime_abi_version() != ABI_VERSION:
                raise RuntimeError("ABI version mismatch")
            _lib = lib
        except Exception as exc:     # no compiler / build failure: numpy
            unavailable_reason = f"{type(exc).__name__}: {exc}"
            if verbose:
                print(f"pgx_torch.native: runtime unavailable "
                      f"({unavailable_reason})")
            _lib = None
        return _lib


def native_available() -> bool:
    """True when the C++ runtime is built and loaded (else the numpy
    fallbacks run)."""
    return load_runtime() is not None


# ---------------------------------------------------------------------------
# Entry points with numpy fallbacks (pgx's, bit for bit)
# ---------------------------------------------------------------------------

def _cptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def normalize_u8(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [-1, 1]."""
    lib = load_runtime()
    if lib is None:
        return src.astype(np.float32) / 127.5 - 1.0
    src = np.ascontiguousarray(src)
    out = np.empty(src.shape, np.float32)
    lib.normalize_u8_to_f32(_cptr(src, ctypes.c_uint8),
                            ctypes.c_int64(src.size),
                            _cptr(out, ctypes.c_float))
    return out


def gather_normalize(images: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Fused batch gather + normalize from a (N, H, W, C) uint8 store."""
    lib = load_runtime()
    if lib is None:
        return images[idx].astype(np.float32) / 127.5 - 1.0
    images = np.ascontiguousarray(images)
    idx = np.ascontiguousarray(idx, np.int64)
    # the numpy semantics for the C++ path too: negative indices wrap,
    # out-of-range raises (the kernel does raw pointer arithmetic)
    n = len(images)
    idx = np.where(idx < 0, idx + n, idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"index out of range for {n} images")
    elems = int(np.prod(images.shape[1:]))
    out = np.empty((len(idx),) + images.shape[1:], np.float32)
    lib.gather_normalize(_cptr(images, ctypes.c_uint8),
                         _cptr(idx, ctypes.c_int64),
                         ctypes.c_int64(len(idx)), ctypes.c_int64(elems),
                         _cptr(out, ctypes.c_float))
    return out


def resize_bilinear(src: np.ndarray, size: int) -> np.ndarray:
    """Batch bilinear (half-pixel, no antialias) resize of NHWC uint8."""
    lib = load_runtime()
    n, h, w, c = src.shape
    if lib is None:
        fy = np.clip((np.arange(size) + 0.5) * (h / size) - 0.5, 0, h - 1)
        fx = np.clip((np.arange(size) + 0.5) * (w / size) - 0.5, 0, w - 1)
        y0 = fy.astype(np.int64)
        x0 = fx.astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        ty = (fy - y0)[None, :, None, None]
        tx = (fx - x0)[None, None, :, None]
        s = src.astype(np.float32)
        top = s[:, y0][:, :, x0] * (1 - tx) + s[:, y0][:, :, x1] * tx
        bot = s[:, y1][:, :, x0] * (1 - tx) + s[:, y1][:, :, x1] * tx
        return (top * (1 - ty) + bot * ty + 0.5).astype(np.uint8)
    src = np.ascontiguousarray(src)
    out = np.empty((n, size, size, c), np.uint8)
    lib.resize_bilinear_u8(_cptr(src, ctypes.c_uint8), ctypes.c_int64(n),
                           ctypes.c_int64(h), ctypes.c_int64(w),
                           ctypes.c_int64(c), _cptr(out, ctypes.c_uint8),
                           ctypes.c_int64(size), ctypes.c_int64(size))
    return out


def resize_box(src: np.ndarray, factor: int) -> np.ndarray:
    """Batch box-filter downsample by an integer factor (antialiased)."""
    lib = load_runtime()
    n, h, w, c = src.shape
    if lib is None:
        oh, ow = h // factor, w // factor
        v = src[:, :oh * factor, :ow * factor].reshape(
            n, oh, factor, ow, factor, c).astype(np.float32)
        return (v.mean(axis=(2, 4)) + 0.5).astype(np.uint8)
    src = np.ascontiguousarray(src)
    out = np.empty((n, h // factor, w // factor, c), np.uint8)
    lib.resize_box_u8(_cptr(src, ctypes.c_uint8), ctypes.c_int64(n),
                      ctypes.c_int64(h), ctypes.c_int64(w),
                      ctypes.c_int64(c), _cptr(out, ctypes.c_uint8),
                      ctypes.c_int64(factor))
    return out
