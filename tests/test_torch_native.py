"""The port's C++ host runtime (``pgx_torch.native``, its own copy of the
runtime source) against ``pgx.native``, both built here with the system's
``g++``: the seven cases of tests/test_native.py (the build and its cache,
normalize, the fused gather, the bilinear and box resizes against the
numpy fallback, the bilinear resize against ``F.interpolate``, negative
and out-of-range indices), each held against pgx's output (the same
source and flags: exact), and the port's numpy fallback against its built
path.  The data path (``pgx_torch.data.pipeline``) runs through it.
"""

import os
import shutil

import numpy as np
import pytest

from pgx import native as jnative
from pgx_torch import native
from pgx_torch.data import pipeline

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both runtimes built afresh, once for the module, into a temporary
    directory (pgx's cache and the port's build directory)."""
    tmp = tmp_path_factory.mktemp("native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PGX_CACHE_DIR", str(tmp / "pgx"))
        mp.setattr(native, "BUILD_ROOT", tmp / "build")
        for mod in (native, jnative):
            mp.setattr(mod, "_lib", None)
            mp.setattr(mod, "_lib_checked", False)
        assert native.load_runtime() is not None
        assert jnative.load_runtime() is not None
        yield tmp
    for mod in (native, jnative):
        mod._lib, mod._lib_checked = None, False


def _fallback(fn, *args):
    """``fn(*args)`` through the numpy fallback (``PGX_DISABLE_NATIVE``)."""
    saved = native._lib, native._lib_checked
    os.environ["PGX_DISABLE_NATIVE"] = "1"
    try:
        native._lib, native._lib_checked = None, False
        assert not native.native_available()
        return fn(*args)
    finally:
        del os.environ["PGX_DISABLE_NATIVE"]
        native._lib, native._lib_checked = saved


def test_runtime_builds_and_caches(built, monkeypatch):
    so = native.library_path()
    assert so.parent.parent == built / "build" and so.exists()
    assert native.native_available()
    assert native.build_seconds is not None
    mtime = os.path.getmtime(so)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_checked", False)
    monkeypatch.setattr(native, "build_seconds", None)
    assert native.load_runtime() is not None
    assert os.path.getmtime(so) == mtime      # loaded, not rebuilt
    assert native.build_seconds is None
    # the port's source is its own copy, ABI 2 as pgx's
    assert native.SOURCE.parent.name == "runtime"
    assert native.SOURCE.parent.parent.name == "pgx_torch"
    assert native.load_runtime().pgx_runtime_abi_version() == 2


def test_normalize_parity(built):
    x = (np.random.RandomState(0).rand(2, 8, 8, 3) * 255).astype(np.uint8)
    got = native.normalize_u8(x)
    np.testing.assert_array_equal(got, jnative.normalize_u8(x))
    np.testing.assert_array_equal(got, x.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(_fallback(native.normalize_u8, x), got)
    np.testing.assert_array_equal(pipeline.normalize_to_unit(x), got)


def test_gather_normalize_parity(built):
    images = (np.random.RandomState(1).rand(16, 4, 4, 3) * 255
              ).astype(np.uint8)
    idx = np.asarray([3, 0, 15, 7])
    got = native.gather_normalize(images, idx)
    np.testing.assert_array_equal(got, jnative.gather_normalize(images, idx))
    np.testing.assert_array_equal(
        got, images[idx].astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(
        _fallback(native.gather_normalize, images, idx), got)


def test_resize_bilinear_matches_fallback(built):
    x = (np.random.RandomState(2).rand(2, 16, 16, 3) * 255).astype(np.uint8)
    got = native.resize_bilinear(x, 8)
    np.testing.assert_array_equal(got, jnative.resize_bilinear(x, 8))
    want = _fallback(native.resize_bilinear, x, 8)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_box_matches_fallback(built):
    x = (np.random.RandomState(3).rand(2, 16, 16, 3) * 255).astype(np.uint8)
    got = native.resize_box(x, 4)
    np.testing.assert_array_equal(got, jnative.resize_box(x, 4))
    want = _fallback(native.resize_box, x, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_torch_parity_bilinear(built):
    import torch
    import torch.nn.functional as F
    x = (np.random.RandomState(4).rand(2, 16, 16, 3) * 255).astype(np.uint8)
    want = F.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2).float(), size=(8, 8),
        mode="bilinear", align_corners=False, antialias=False)
    got = native.resize_bilinear(x, 8).astype(np.float32)
    assert np.abs(got - want.permute(0, 2, 3, 1).numpy()).max() <= 1.0


def test_gather_normalize_negative_and_oob_indices(built):
    images = (np.random.RandomState(3).rand(8, 4, 4, 1) * 255
              ).astype(np.uint8)
    idx = np.asarray([-1, 0, -8])
    got = native.gather_normalize(images, idx)
    np.testing.assert_array_equal(got, jnative.gather_normalize(images, idx))
    np.testing.assert_array_equal(
        got, images[idx].astype(np.float32) / 127.5 - 1.0)
    for bad in ([8], [-9]):
        with pytest.raises(IndexError):
            native.gather_normalize(images, np.asarray(bad))
        with pytest.raises(IndexError):
            _fallback(native.gather_normalize, images, np.asarray(bad))


def test_array_batches_take_the_runtime(built, monkeypatch):
    """The batch stream gathers and normalizes through the runtime, batch
    for batch what the fallback streams."""
    from pgx_torch.data.datasets import synthetic_dataset
    ds = synthetic_dataset(n=16, size=8, channels=3, num_classes=3, seed=0)
    def five():
        stream = pipeline.array_batches(ds, 4, 8, seed=2)
        return [next(stream) for _ in range(5)]
    calls = []
    gather = native.gather_normalize
    monkeypatch.setattr(native, "gather_normalize",
                        lambda *a: calls.append(1) or gather(*a))
    got = five()
    assert len(calls) == 5
    fallback = _fallback(five)
    for (a, la), (b, lb) in zip(got, fallback):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
