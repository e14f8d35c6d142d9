"""Host-side datasets: a copy of ``pgx/data/datasets.py`` (numpy only).

Every loader reads local files; tests and the chip smoke use
``synthetic_dataset``.  All datasets expose uint8 images (N, H, W, C) plus
optional int labels, and per-resolution caching so each growth stage samples
from a pre-resized array (the resize happens once per stage).

``_resize_batch`` is PIL's BILINEAR resample written in numpy, so the array
path needs no PIL: it gives PIL's bytes exactly.  The folder and WikiArt
loaders decode files through PIL, imported where they decode.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


_PRECISION_BITS = 32 - 8 - 2      # PIL's fixed point for 8-bit images


def _bilinear_taps(in_size: int, out_size: int):
    """PIL's BILINEAR coefficients for one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` of Pillow's Resample.c): a triangle filter
    whose support scales with the downscale factor, each output's weights
    normalised in double and rounded to fixed point.  Returns ``(index,
    weight)``, int64 arrays of shape (out_size, taps); unused taps read
    index 0 with weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale       # the triangle's support is 1
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in ws:
            total += w
        for x, w in enumerate(ws):
            if total != 0.0:
                w /= total
            fixed = w * (1 << _PRECISION_BITS)
            weight[xx, x] = int(fixed - 0.5) if w < 0 else int(fixed + 0.5)
            index[xx, x] = xmin + x
    return index, weight


def _resample_axis(images: np.ndarray, size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of uint8 NHWC ``images``: the fixed-point
    sum with PIL's half-unit rounding offset, clipped to uint8."""
    index, weight = _bilinear_taps(images.shape[axis], size)
    acc = np.full(images.shape[:axis] + (size,) + images.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    bshape = [1] * images.ndim
    bshape[axis] = size
    for k in range(index.shape[1]):
        acc += (np.take(images, index[:, k], axis=axis).astype(np.int64)
                * weight[:, k].reshape(bshape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_batch(images: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of uint8 NHWC images to ``size`` x ``size``, equal
    byte for byte to PIL's ``Image.resize((size, size), Image.BILINEAR)``
    (torchvision's Resize): the horizontal pass first, then the vertical
    one on its uint8 result."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    out = images
    if images.shape[2] != size:
        out = _resample_axis(out, size, axis=2)
    if images.shape[1] != size:
        out = _resample_axis(out, size, axis=1)
    return out


def _balanced_subset_indices(labels, num_classes: int, n: int,
                             seed: int, total: int = None) -> np.ndarray:
    """Deterministic sorted index subset of exactly ``n`` items,
    class-balanced when labels exist (topped up round-robin when n isn't a
    multiple of num_classes or classes run short)."""
    rng = np.random.RandomState(seed)
    if labels is None or not num_classes:
        return np.sort(rng.permutation(total)[:n])
    labels = np.asarray(labels)
    per_class = [rng.permutation(np.flatnonzero(labels == c))
                 for c in range(num_classes)]
    picked = []
    depth = 0
    while len(picked) < n and any(depth < len(p) for p in per_class):
        for p in per_class:            # round-robin one item per class
            if depth < len(p):
                picked.append(p[depth])
                if len(picked) == n:
                    break
        depth += 1
    return np.sort(np.asarray(picked[:n]))


class ArrayDataset:
    """In-memory dataset with per-resolution uint8 caches."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None,
                 num_classes: int = 0):
        assert images.dtype == np.uint8 and images.ndim == 4
        self.images = images
        self.labels = labels
        self.num_classes = num_classes
        self._cache: Dict[int, np.ndarray] = {images.shape[1]: images} \
            if images.shape[1] == images.shape[2] else {}

    def __len__(self) -> int:
        return len(self.images)

    def at_resolution(self, size: int) -> np.ndarray:
        if size not in self._cache:
            self._cache[size] = _resize_batch(self.images, size)
        return self._cache[size]

    def subset(self, n: int, seed: int = 0) -> "ArrayDataset":
        """Deterministic subset of ``n`` images, class-balanced when labels
        exist (limited-data training — the regime ADA was designed for)."""
        n = min(n, len(self.images))
        idx = _balanced_subset_indices(self.labels, self.num_classes, n,
                                       seed, total=len(self.images))
        labels = self.labels[idx] if self.labels is not None else None
        return ArrayDataset(np.ascontiguousarray(self.images[idx]), labels,
                            num_classes=self.num_classes)


def synthetic_dataset(n: int = 512, size: int = 32, channels: int = 3,
                      num_classes: int = 0, seed: int = 0) -> ArrayDataset:
    """Deterministic structured noise (blobs), for tests and benchmarks.

    With ``num_classes`` the blob color is tied to the class, so class
    conditioning is actually learnable from this data."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, channels), np.uint8)
    labels = rng.randint(0, num_classes, n) if num_classes else None
    for i in range(n):
        cx, cy, s = rng.rand(3)
        base = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.05 + 0.2 * s)))
        if num_classes and channels == 3:
            hue = 2 * np.pi * labels[i] / num_classes
            color = 0.5 + 0.5 * np.cos(
                hue + np.array([0.0, 2.1, 4.2], np.float32))
        else:
            color = rng.rand(channels)
        img = base[:, :, None] * color.reshape(1, 1, channels)
        img += 0.1 * rng.rand(size, size, channels)
        imgs[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return ArrayDataset(imgs, labels, num_classes)


# ---------------------------------------------------------------------------
# MNIST / CIFAR-10 from local files (no egress)
# ---------------------------------------------------------------------------

def load_mnist(root: str, train: bool = True) -> ArrayDataset:
    """Read raw idx files (train-images-idx3-ubyte[.gz] layout)."""
    prefix = "train" if train else "t10k"
    def _open(name):
        for cand in (name, name + ".gz"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return gzip.open(p, "rb") if cand.endswith(".gz") else open(p, "rb")
        raise FileNotFoundError(os.path.join(root, name))
    with _open(f"{prefix}-images-idx3-ubyte") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        assert magic == 2051
        images = np.frombuffer(f.read(n * h * w), np.uint8).reshape(n, h, w, 1)
    with _open(f"{prefix}-labels-idx1-ubyte") as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        assert magic == 2049 and n2 == n
        labels = np.frombuffer(f.read(n), np.uint8).astype(np.int64)
    return ArrayDataset(np.ascontiguousarray(images), labels, num_classes=10)


def load_sklearn_digits(rgb: bool = False) -> ArrayDataset:
    """The UCI handwritten-digits set bundled with scikit-learn: 1797 real
    8x8 grayscale digit images, no network needed.  The smallest real
    dataset on which the MNIST-family configs train end-to-end — and,
    being tiny, the ideal ADA demonstration (D overfits fast, so the
    adaptive-p controller visibly engages).  ``rgb`` replicates the gray
    channel to 3 so the RGB model families (legacy/proper CIFAR-style)
    can train on real data too."""
    from sklearn.datasets import load_digits
    bunch = load_digits()
    imgs = (bunch.images / 16.0 * 255.0).astype(np.uint8)[..., None]
    if rgb:
        imgs = np.repeat(imgs, 3, axis=-1)
    labels = bunch.target.astype(np.int64)
    return ArrayDataset(np.ascontiguousarray(imgs), labels, num_classes=10)


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    """Read the python-pickle batches (cifar-10-batches-py)."""
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = root
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x), np.asarray(ys, np.int64),
                        num_classes=10)


# ---------------------------------------------------------------------------
# Image folders (CelebA-style) and WikiArt metadata CSV
# ---------------------------------------------------------------------------

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class ImageFolderDataset:
    """Lazy folder dataset: class subdirectories (datasets.ImageFolder
    semantics, train.py:40) or a flat directory of images."""

    def __init__(self, root: str, resize_factor: float = 1.0,
                 random_crop: bool = False, hflip: bool = False,
                 seed: int = 0, cache_bytes: int = 2 << 30):
        self.root = root
        self.resize_factor = resize_factor
        self.random_crop = random_crop
        self.hflip = hflip
        self.seed = seed
        # bounded LRU cache of decoded+resized (pre-crop) uint8 arrays keyed
        # (idx, size): the decode+resize is deterministic per key, so caching
        # it cannot change the counter-derived crop/flip stream — it only
        # removes the per-iteration PNG decode, the host-side bottleneck at
        # low resolutions
        self._cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cache_bytes = 0
        self._cache_budget = max(0, cache_bytes)
        self._cache_lock = threading.Lock()
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.paths, labels = [], []
        if classes:
            for ci, cls in enumerate(classes):
                for n in sorted(os.listdir(os.path.join(root, cls))):
                    if n.lower().endswith(_IMG_EXTS):
                        self.paths.append(os.path.join(root, cls, n))
                        labels.append(ci)
            self.labels = np.asarray(labels, np.int64)
            self.num_classes = len(classes)
        else:
            self.paths = [os.path.join(root, n) for n in sorted(os.listdir(root))
                          if n.lower().endswith(_IMG_EXTS)]
            self.labels = None
            self.num_classes = 0

    def __len__(self) -> int:
        return len(self.paths)

    def limit(self, n: int, seed: int = 0) -> "ImageFolderDataset":
        """Restrict to a deterministic class-balanced subset of ``n``
        files in place (``--limit-images``); returns self."""
        n = min(n, len(self.paths))
        idx = _balanced_subset_indices(self.labels, self.num_classes, n,
                                       seed, total=len(self.paths))
        self.paths = [self.paths[i] for i in idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        # the decode cache is keyed by (index, size, ...): entries cached
        # before the remap would alias different files after it
        with self._cache_lock:
            self._cache.clear()
            self._cache_bytes = 0
        return self

    def load(self, idx: int, size: int, seed: Optional[int] = None,
             epoch: int = 0) -> np.ndarray:
        """CelebA-style transform (train.py:37-41):
        Resize(size + int(size*0.2) + 1) — torchvision semantics: scale the
        SHORTER edge, preserving aspect ratio — then RandomCrop(size) and
        RandomHorizontalFlip.

        Crop/flip randomness is a pure function of ``(seed, epoch, idx)``
        (counter-derived, not a mutable stream), so a resumed run and two
        prefetcher restarts at the same iteration see the SAME augmentation
        stream — matching the array path's per-stage seeding."""
        key = (idx, size)
        with self._cache_lock:
            arr = self._cache.get(key)
            if arr is not None:
                self._cache.move_to_end(key)
        if arr is None:
            arr = self._decode_resized(idx, size)
            arr.setflags(write=False)  # cached array is shared via views
            if self._cache_budget:
                with self._cache_lock:
                    if key not in self._cache:
                        self._cache[key] = arr
                        self._cache_bytes += arr.nbytes
                        while self._cache_bytes > self._cache_budget:
                            _, old = self._cache.popitem(last=False)
                            self._cache_bytes -= old.nbytes
        h, w = arr.shape[:2]
        if self.random_crop or self.hflip:
            base = self.seed if seed is None else seed
            rng = np.random.RandomState(
                np.random.SeedSequence((base, epoch, idx)).generate_state(4))
        if self.random_crop:
            y = rng.randint(0, h - size + 1)
            x = rng.randint(0, w - size + 1)
        else:
            y, x = (h - size) // 2, (w - size) // 2
        arr = arr[y:y + size, x:x + size]
        if self.hflip and rng.rand() < 0.5:
            arr = arr[:, ::-1]
        return arr

    def _decode_resized(self, idx: int, size: int) -> np.ndarray:
        """Decode + aspect-preserving shorter-edge resize (the deterministic,
        cacheable prefix of ``load``)."""
        from PIL import Image
        im = Image.open(self.paths[idx]).convert("RGB")
        if self.resize_factor > 1.0:
            short = size + int(size * (self.resize_factor - 1.0)) + 1
        else:
            short = size
        w0, h0 = im.size
        scale = short / min(w0, h0)
        rw = max(short, int(round(w0 * scale)))
        rh = max(short, int(round(h0 * scale)))
        im = im.resize((rw, rh), Image.BILINEAR)
        return np.asarray(im, np.uint8)


class WikiArtDataset:
    """Metadata-CSV dataset (conditional_proper_wikiart.py:22-47): columns
    filename,category,size; filters rows with size >= current resolution."""

    def __init__(self, csv_path: str, image_root: str):
        import csv as _csv
        self.image_root = image_root
        self.rows = []
        cats = {}
        with open(csv_path) as f:
            for row in _csv.DictReader(f):
                cat = row["category"]
                cats.setdefault(cat, len(cats))
                self.rows.append((row["filename"], cat, int(row["size"])))
        self.categories = cats
        self.num_classes = len(cats)

    def limit(self, n: int, seed: int = 0) -> "WikiArtDataset":
        """Restrict to a deterministic category-balanced subset of ``n``
        rows in place (``--limit-images``); returns self."""
        n = min(n, len(self.rows))
        labels = np.asarray([self.categories[c] for _, c, _ in self.rows])
        idx = _balanced_subset_indices(labels, self.num_classes, n, seed,
                                       total=len(self.rows))
        self.rows = [self.rows[i] for i in idx]
        return self

    def subset_for(self, size: int):
        return [(f, self.categories[c]) for f, c, s in self.rows if s >= size]

    def load(self, filename: str, size: int) -> np.ndarray:
        from PIL import Image
        im = Image.open(os.path.join(self.image_root, filename)).convert("RGB")
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)
