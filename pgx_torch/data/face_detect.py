"""Self-contained face detector: multi-scale normalized cross-correlation
against an analytic face template.  Pure numpy/scipy/PIL — no pretrained
weights, no native detector library.  Counterpart of
``pgx/data/face_detect.py``; a copy kept here so that the port imports
nothing of ``pgx``.

Why this exists: the reference's portrait pipeline centers crops on a
detected face (data/face_detection_tests.py:12-26, MTCNN), but every
pretrained detector needs either downloaded weights (facenet/mtcnn) or
bundled cascade data (cv2 — a 5.0 wheel may ship neither
``CascadeClassifier`` nor cascade files).  The detector chain
(pgx_torch/data/prep.py default_face_detector) prefers those when installed;
this module is the always-available last leg so face-centered cropping
WORKS everywhere, at classical-heuristic quality: good on clear frontal
faces and synthetic portraits, no match for a learned detector on hard
poses — exactly the cases the reference script routed to manual review.

Method: a zero-mean unit-norm 24x24 template (bright face oval, dark eye
blobs, dark mouth bar) is slid over a grayscale image pyramid; at each
scale the local zero-mean normalized cross-correlation (template matching
with per-window variance from integral images, the classical Lewis'95
fast-NCC formulation) scores every window, and the best score above
``threshold`` across all scales wins.  Random texture peaks below ~0.2
for a 576-pixel template, so the default threshold 0.5 rejects
non-face content while synthetic/clear faces score 0.6+.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

TEMPLATE_SIZE = 24


@functools.lru_cache(maxsize=1)
def face_template(size: int = TEMPLATE_SIZE) -> np.ndarray:
    """Analytic frontal-face template, zero-mean and unit-norm."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)
    t = np.zeros((size, size), np.float64)
    oval = (((yy - 0.52) / 0.48) ** 2 + ((xx - 0.50) / 0.40) ** 2) <= 1.0
    t[oval] = 1.0
    for ex in (0.32, 0.68):     # eye sockets
        eye = (((yy - 0.38) / 0.10) ** 2 + ((xx - ex) / 0.11) ** 2) <= 1.0
        t[eye] = -1.0
    mouth = (yy >= 0.70) & (yy <= 0.80) & (xx >= 0.35) & (xx <= 0.65)
    t[mouth] = -1.0
    t -= t.mean()
    t /= np.sqrt(np.sum(t * t))
    return t


def _resize_gray(gray: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image
    im = Image.fromarray(gray.astype(np.float32), mode="F")
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.float64)


def _ncc_valid(gray: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Zero-mean NCC of unit-norm zero-mean template ``t`` over every
    valid window of ``gray``: corr(t, x) / ||x - mean(x)||."""
    from scipy.signal import fftconvolve

    k = t.shape[0]
    n = k * k
    corr = fftconvolve(gray, t[::-1, ::-1], mode="valid")
    # per-window mean and sum-of-squares via integral images
    ii = np.zeros((gray.shape[0] + 1, gray.shape[1] + 1))
    ii2 = np.zeros_like(ii)
    ii[1:, 1:] = np.cumsum(np.cumsum(gray, 0), 1)
    ii2[1:, 1:] = np.cumsum(np.cumsum(gray * gray, 0), 1)

    def wsum(a):
        return a[k:, k:] - a[:-k, k:] - a[k:, :-k] + a[:-k, :-k]

    s1, s2 = wsum(ii), wsum(ii2)
    var = np.maximum(s2 - s1 * s1 / n, 0.0)
    norm = np.sqrt(var)
    flat = norm < 1e-6 * np.sqrt(n)   # constant windows: undefined NCC
    norm = np.where(flat, 1.0, norm)
    return np.where(flat, 0.0, corr / norm)


def detect_face(img: np.ndarray, min_size: int = TEMPLATE_SIZE,
                threshold: float = 0.5,
                scale_step: float = 1.25) -> Optional[Tuple[int, int]]:
    """Best face-like window center ``(cx, cy)`` in original-image
    coordinates, or None when nothing scores above ``threshold`` — the
    ``img -> point | None`` contract of pgx_torch.data.prep's detector chain."""
    if img.ndim == 3:
        gray = img.astype(np.float64).mean(axis=-1)
    else:
        gray = img.astype(np.float64)
    h, w = gray.shape
    if min(h, w) < min_size:
        return None
    t = face_template()
    k = t.shape[0]
    best = None   # (score, cx, cy)
    s = float(min_size)
    while s <= min(h, w):
        factor = k / s    # shrink so faces of size s match the template
        gh, gw = max(int(round(h * factor)), k), max(int(round(w * factor)),
                                                     k)
        g = _resize_gray(gray, gh, gw) if (gh, gw) != (h, w) else gray
        scores = _ncc_valid(g, t)
        iy, ix = np.unravel_index(np.argmax(scores), scores.shape)
        sc = float(scores[iy, ix])
        if sc >= threshold and (best is None or sc > best[0]):
            fy, fx = h / gh, w / gw   # scaled -> original coords
            best = (sc, (ix + k / 2) * fx, (iy + k / 2) * fy)
        s *= scale_step
    if best is None:
        return None
    return int(round(best[1])), int(round(best[2]))
