"""pgx_torch's data path against pgx's, on the CPU.

Everything here is exact: the port's numpy code must give pgx's arrays bit
for bit.  ``_resize_batch`` is PIL's BILINEAR resample written in numpy;
pgx calls PIL itself.  pgx's batches go through its C++ runtime when that is
built (``normalize_u8_to_f32``, ``gather_normalize``), which divides by
127.5 in float32 as the port's numpy does.  The prefetcher runs here with
``device="cpu"`` (the card's pinned-buffer path is in
tests/test_torch_loop_gpu.py).
"""

import itertools
import os
import threading

import numpy as np
import pytest
import torch

from pgx.data import datasets as jds
from pgx.data import pipeline as jpipe
from pgx_torch.data import datasets as tds
from pgx_torch.data import pipeline as tpipe
from pgx_torch.data import DevicePrefetcher


@pytest.mark.parametrize("n,size,channels,num_classes",
                         [(12, 32, 3, 10), (9, 16, 1, 0), (7, 8, 3, 0),
                          (5, 32, 1, 4)])
def test_synthetic_dataset_matches_pgx(n, size, channels, num_classes):
    got = tds.synthetic_dataset(n, size, channels, num_classes, seed=3)
    want = jds.synthetic_dataset(n, size, channels, num_classes, seed=3)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.images.dtype == want.images.dtype == np.uint8
    if num_classes:
        np.testing.assert_array_equal(got.labels, want.labels)
    else:
        assert got.labels is None and want.labels is None
    assert got.num_classes == want.num_classes


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size", [4, 8, 16, 21, 64, 128])
def test_resize_batch_equals_pil(size, channels):
    images = tds.synthetic_dataset(6, 32, channels, seed=1).images
    got = tds._resize_batch(images, size)
    want = jds._resize_batch(images, size)
    assert got.shape == want.shape == (6, size, size, channels)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,size", [(17, 8), (13, 32), (31, 5),
                                          (3, 128), (32, 1)])
def test_resize_batch_equals_pil_on_noise(in_size, size):
    """Full-range noise at odd sizes, up and down: every rounding and clip
    of the fixed-point sums shows."""
    rng = np.random.RandomState(in_size * 1000 + size)
    images = rng.randint(0, 256, (3, in_size, in_size, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tds._resize_batch(images, size),
                                  jds._resize_batch(images, size))


def test_resize_batch_passes_matching_size_through():
    images = tds.synthetic_dataset(2, 16, 3).images
    assert tds._resize_batch(images, 16) is images


def test_at_resolution_matches_pgx():
    got = tds.synthetic_dataset(5, 32, 3, 10, seed=2)
    want = jds.synthetic_dataset(5, 32, 3, 10, seed=2)
    for size in (8, 64, 32):
        np.testing.assert_array_equal(got.at_resolution(size),
                                      want.at_resolution(size))
    assert got.at_resolution(8) is got.at_resolution(8)


def test_normalize_to_unit_matches_pgx():
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 8, 8)
    got = tpipe.normalize_to_unit(x)
    want = jpipe.normalize_to_unit(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() == -1.0 and got.max() == 1.0


@pytest.mark.parametrize("labels", [True, False])
def test_array_batches_match_pgx(labels):
    """20 batches of 4 over 30 images: 7 a epoch, so the stream crosses two
    epoch boundaries (and drops each epoch's last two images)."""
    kw = dict(n=30, size=32, channels=3, num_classes=5 if labels else 0,
              seed=4)
    got_ds, want_ds = tds.synthetic_dataset(**kw), jds.synthetic_dataset(**kw)
    got = tpipe.array_batches(got_ds, 4, 16, seed=9)
    want = jpipe.array_batches(want_ds, 4, 16, seed=9)
    for k in range(20):
        (gi, gl), (wi, wl) = next(got), next(want)
        assert gi.dtype == np.float32 and gi.shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(gi, wi, err_msg=f"batch {k}")
        if labels:
            np.testing.assert_array_equal(gl, wl, err_msg=f"batch {k}")
        else:
            assert gl is None and wl is None


def test_array_batches_refuse_a_batch_larger_than_the_data():
    ds = tds.synthetic_dataset(3, 8, 3)
    with pytest.raises(ValueError, match="exceeds"):
        next(tpipe.array_batches(ds, 4, 8))


@pytest.mark.parametrize("n", [10, 7, 40])
def test_subset_matches_pgx(n):
    got = tds.synthetic_dataset(30, 8, 3, 4, seed=5).subset(n, seed=2)
    want = jds.synthetic_dataset(30, 8, 3, 4, seed=5).subset(n, seed=2)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    unlabelled = tds.synthetic_dataset(30, 8, 3, seed=5).subset(n, seed=2)
    np.testing.assert_array_equal(
        unlabelled.images,
        jds.synthetic_dataset(30, 8, 3, seed=5).subset(n, seed=2).images)


def _write_folder(root, shapes):
    from PIL import Image
    rng = np.random.RandomState(0)
    for k, (cls, w, h) in enumerate(shapes):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, cls, f"{k}.png"))


@pytest.mark.parametrize("workers", [0, 2])
def test_folder_batches_match_pgx(tmp_path, workers):
    _write_folder(str(tmp_path), [("a", 40, 52), ("b", 37, 30),
                                  ("a", 64, 64), ("b", 20, 45),
                                  ("c", 50, 33), ("c", 33, 33)])
    kw = dict(resize_factor=1.2, random_crop=True, hflip=True, seed=3)
    got_ds = tds.ImageFolderDataset(str(tmp_path), **kw)
    want_ds = jds.ImageFolderDataset(str(tmp_path), **kw)
    assert got_ds.paths == want_ds.paths and got_ds.num_classes == 3
    got = tpipe.folder_batches(got_ds, 4, 16, seed=1, num_workers=workers)
    want = jpipe.folder_batches(want_ds, 4, 16, seed=1, num_workers=0)
    for k in range(4):        # 1 batch an epoch: four epochs
        (gi, gl), (wi, wl) = next(got), next(want)
        assert gi.shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(gi, wi, err_msg=f"batch {k}")
        np.testing.assert_array_equal(gl, wl, err_msg=f"batch {k}")
    got.close()
    limited = tds.ImageFolderDataset(str(tmp_path), seed=3).limit(3, seed=1)
    assert limited.paths == jds.ImageFolderDataset(
        str(tmp_path), seed=3).limit(3, seed=1).paths


def test_prefetcher_cpu_yields_the_stream_in_order():
    ds = tds.synthetic_dataset(20, 16, 3, 4, seed=6)
    want = tpipe.array_batches(ds, 4, 8, seed=2)
    pf = DevicePrefetcher(tpipe.array_batches(ds, 4, 8, seed=2), "cpu")
    try:
        for k in range(12):
            imgs, labels = next(pf)
            wi, wl = next(want)
            assert isinstance(imgs, torch.Tensor)
            assert imgs.device.type == "cpu" and imgs.dtype == torch.float32
            assert labels.dtype == torch.int64
            np.testing.assert_array_equal(imgs.numpy(), wi,
                                          err_msg=f"batch {k}")
            np.testing.assert_array_equal(labels.numpy(), wl)
        assert pf.wait_s >= 0.0
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_passes_none_labels_and_stops_at_the_end():
    batches = [(np.full((2, 4, 4, 3), k, np.float32), None)
               for k in range(3)]
    pf = DevicePrefetcher(iter(batches), "cpu", depth=1)
    got = [(imgs[0, 0, 0, 0].item(), labels) for imgs, labels in pf]
    assert got == [(0.0, None), (1.0, None), (2.0, None)]
    pf.close()


def test_prefetcher_raises_the_worker_error():
    def stream():
        for k in range(3):
            yield np.zeros((2, 4, 4, 3), np.float32) + k, None
        raise ValueError("bad batch 3")

    pf = DevicePrefetcher(stream(), "cpu")
    try:
        assert [float(next(pf)[0][0, 0, 0, 0]) for _ in range(3)] == [
            0.0, 1.0, 2.0]
        with pytest.raises(RuntimeError, match="worker failed") as info:
            next(pf)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        pf.close()


def test_prefetcher_close_stops_the_worker():
    """The worker blocks on a full queue of an endless stream; close()
    ends it within its timeout."""
    produced = itertools.count()

    def endless():
        for k in produced:
            yield np.full((1, 2, 2, 3), k, np.float32), None

    before = threading.active_count()
    pf = DevicePrefetcher(endless(), "cpu", depth=2)
    assert float(next(pf)[0].sum()) == 0.0
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() <= before


def test_prefetcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(iter([]), "cuda")
