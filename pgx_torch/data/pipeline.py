"""Batching, normalization, and device prefetch.

Counterpart of ``pgx/data/pipeline.py``: numpy batch assembly on the host,
``[-1, 1]`` normalization (the C++ runtime's gather and normalize,
``pgx_torch.native``, or its numpy fallback), and a background thread that lands each batch on
the device one step ahead, so the card does not wait on the host.  The
batch streams are ``pgx``'s, batch for batch.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from pgx_torch import native
from pgx_torch.data.datasets import ArrayDataset, ImageFolderDataset
from pgx_torch.utils import resolve_device, trace


def normalize_to_unit(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1, 1] (Normalize(0.5, 0.5)): the C++
    runtime (``pgx_torch.native``) when it is built, numpy otherwise; both
    divide in float32 by 127.5, bit for bit."""
    if images_u8.dtype == np.uint8:
        return native.normalize_u8(images_u8)
    return images_u8.astype(np.float32) / 127.5 - 1.0


def array_batches(dataset: ArrayDataset, batch_size: int, resolution: int,
                  seed: int = 0) -> Iterator[Tuple[np.ndarray,
                                                   Optional[np.ndarray]]]:
    """Infinite shuffled epochs over a per-resolution cache."""
    images = dataset.at_resolution(resolution)
    labels = dataset.labels
    rng = np.random.RandomState(seed)
    n = len(images)
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {n} available images at "
            f"{resolution}px — the epoch loop would yield nothing and "
            f"training would hang (reduce the batch or --limit-images less)")
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            # the runtime's fused gather + normalize when it is built
            batch = (native.gather_normalize(images, idx)
                     if images.dtype == np.uint8
                     else normalize_to_unit(images[idx]))
            yield batch, labels[idx] if labels is not None else None


@contextmanager
def ordered_map_pool(num_workers: int):
    """Yield an order-preserving map over an optional decode thread pool
    (``num_workers == 0`` -> builtin ``map``, fully synchronous); the pool
    is shut down (queued work cancelled) on exit.  Order preservation keeps
    a worker-pool batch stream bit-identical to the synchronous path."""
    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(num_workers)
        try:
            yield pool.map
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
    else:
        yield map


def folder_batches(dataset: ImageFolderDataset, batch_size: int,
                   resolution: int, seed: int = 0, num_workers: int = 0
                   ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """``num_workers > 0`` decodes each batch's images through a thread
    pool with a stream identical to the synchronous path: every load is
    keyed by (seed, epoch, index)."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {n} available images — "
            f"the epoch loop would yield nothing and training would hang")
    epoch = 0
    with ordered_map_pool(num_workers) as pmap:
        while True:
            order = rng.permutation(n)
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start:start + batch_size]
                load = (lambda i, e=epoch: dataset.load(
                    int(i), resolution, seed=seed, epoch=e))
                imgs = np.stack(list(pmap(load, idx)))
                labs = (dataset.labels[idx] if dataset.labels is not None
                        else None)
                yield normalize_to_unit(imgs), labs
            epoch += 1


class _Slot:
    """One pinned host buffer pair and the event that marks its upload
    done: the buffer is refilled only after that event."""

    def __init__(self):
        self.host = {}
        self.done: Optional[torch.cuda.Event] = None

    def pinned(self, key: str, arr: np.ndarray) -> torch.Tensor:
        buf = self.host.get(key)
        if buf is None or buf.shape != arr.shape or buf.dtype != _dtype(arr):
            buf = torch.empty(arr.shape, dtype=_dtype(arr), pin_memory=True)
            self.host[key] = buf
        buf.numpy()[...] = arr
        return buf


def _dtype(arr: np.ndarray) -> torch.dtype:
    return torch.from_numpy(arr[:0]).dtype


class DevicePrefetcher:
    """Background thread that assembles and uploads the next batches while
    the current train step runs.  Yields ``(images, labels)`` tensors on
    ``device`` (labels None when the stream has none).

    On a CUDA device each batch is copied into a pinned host buffer (a ring
    of ``depth + 1``, each reused only after its upload has finished) and
    uploaded with ``non_blocking=True`` on a stream of its own; ``__next__``
    makes the current stream wait for that upload and records the tensors
    on it, so the caching allocator does not reuse their memory while the
    step still reads them.  On the CPU the batches are wrapped as tensors.
    An exception in the worker is raised in the consumer; ``close()`` stops
    the worker.  ``wait_s`` sums the time ``__next__`` waited for a batch
    (each wait a ``data.wait`` span, ``pgx_torch.utils.trace``).
    """

    _SENTINEL = object()

    def __init__(self, iterator, device="cuda", depth: int = 2):
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._slots = [_Slot() for _ in range(depth + 1)] if self._cuda \
            else []
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _upload(self, batch, n: int):
        imgs, labels = batch
        if not self._cuda:
            return (torch.from_numpy(np.ascontiguousarray(imgs)),
                    None if labels is None
                    else torch.from_numpy(np.ascontiguousarray(labels)),
                    None)
        slot = self._slots[n % len(self._slots)]
        if slot.done is not None:
            slot.done.synchronize()
        host = [slot.pinned("images", np.asarray(imgs))]
        if labels is not None:
            host.append(slot.pinned("labels", np.asarray(labels)))
        with torch.cuda.stream(self._stream):
            dev = [h.to(self._device, non_blocking=True) for h in host]
            slot.done = torch.cuda.Event()
            slot.done.record(self._stream)
        return dev[0], dev[1] if labels is not None else None, slot.done

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            for n, batch in enumerate(self._iterator):
                if self._stop.is_set() or not self._put(
                        self._upload(batch, n)):
                    return
        except BaseException as exc:  # surfaced in the consumer thread
            self._error = exc
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        with trace.span("data.wait"):
            t0 = time.perf_counter()
            item = self._q.get()
            self.wait_s += time.perf_counter() - t0
        if item is self._SENTINEL:
            if self._error is not None:
                raise RuntimeError(
                    "DevicePrefetcher worker failed") from self._error
            raise StopIteration
        imgs, labels, done = item
        if done is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(done)
            for t in (imgs, labels):
                if t is not None:
                    t.record_stream(current)
        return imgs, labels

    def close(self):
        """Stop the worker and wait for it (10 s at most: it stops at its
        next batch)."""
        self._stop.set()
        self._thread.join(10.0)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
