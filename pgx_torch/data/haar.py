"""Pure-numpy Viola-Jones Haar-cascade evaluator (counterpart of
``pgx/data/haar.py``; a copy kept here so that the port imports nothing of
``pgx``, reading its own copy of the cascade file).

Runs OpenCV's trained stump cascades (the vendored
``cascades/haarcascade_frontalface_default.xml``) without OpenCV: a cv2
wheel may ship neither ``CascadeClassifier`` nor cascade data, yet the
reference's portrait pipeline needs real face detection
(data/face_detection_tests.py:27-64).  The engine is the classical
algorithm (Viola & Jones 2001, as implemented by OpenCV's
cascadedetect.cpp for BOOST/HAAR stump cascades):

* image pyramid — the grayscale image is rescaled per scale step and slid
  with the cascade's native 24x24 window (modern OpenCV's strategy; the
  old feature-scaling path is rounding-noisier);
* per window, variance normalization over the 1-px-inset norm rect
  (OpenCV's ``normrect = Rect(1, 1, w-2, h-2)``);
* each weak stump compares an area-normalized 2-3-rect Haar feature sum
  against ``threshold * stddev`` and contributes one of two leaf values;
  a stage rejects when its stump sum falls below the stage threshold;
* candidate windows are evaluated in lock-step numpy vectors with an
  alive mask — stage 1 kills most windows, so the work per stage decays
  geometrically exactly as the cascade was trained to arrange;
* accepted boxes across scales are grouped OpenCV-style (rectangle
  clustering at eps=0.2 with a min-neighbors vote).

Host-side prep tooling: ~1-3 s per megapixel image in numpy — plenty for
offline dataset preparation, not a video-rate detector.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

CASCADE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "cascades")
FRONTALFACE_PATH = os.path.join(CASCADE_DIR,
                                "haarcascade_frontalface_default.xml")


class HaarCascade:
    """Parsed OpenCV cascade (new XML format, BOOST stages over HAAR
    stump features, ``maxCatCount == 0``)."""

    def __init__(self, path: str = FRONTALFACE_PATH):
        root = ET.parse(path).getroot()
        c = root.find("cascade")
        if c is None or (c.findtext("featureType") or "").strip() != "HAAR":
            raise ValueError(f"not a HAAR stump cascade: {path}")
        self.win_h = int(c.findtext("height"))
        self.win_w = int(c.findtext("width"))

        feats = c.find("features")
        n_feat = len(feats)
        # up to 3 weighted rects per feature, zero-padded
        self.rects = np.zeros((n_feat, 3, 5), np.float64)  # x y w h weight
        for i, f in enumerate(feats):
            for j, r in enumerate(f.find("rects")):
                vals = [float(v.rstrip(".")) for v in r.text.split()]
                self.rects[i, j] = vals

        self.stages: List[Tuple[float, slice]] = []
        feat_idx, thresh, left, right = [], [], [], []
        for s in c.find("stages"):
            st = float(s.findtext("stageThreshold"))
            start = len(feat_idx)
            for wc in s.find("weakClassifiers"):
                nodes = wc.findtext("internalNodes").split()
                leaves = [float(v) for v in
                          wc.findtext("leafValues").split()]
                # stump: internalNodes = [left=0, right=-1, featIdx, thr]
                feat_idx.append(int(nodes[2]))
                thresh.append(float(nodes[3]))
                left.append(leaves[0])
                right.append(leaves[1])
            self.stages.append((st, slice(start, len(feat_idx))))
        self.feat_idx = np.asarray(feat_idx, np.int64)
        self.thresh = np.asarray(thresh, np.float64)
        self.left = np.asarray(left, np.float64)
        self.right = np.asarray(right, np.float64)

    # -- evaluation -------------------------------------------------------
    def _scan_scale(self, gray: np.ndarray, step: int) -> np.ndarray:
        """All accepted 24x24 window origins (N, 2) = (y, x) on ``gray``."""
        h, w = gray.shape
        wh, ww = self.win_h, self.win_w
        if h < wh or w < ww:
            return np.zeros((0, 2), np.int64)
        ii = np.zeros((h + 1, w + 1), np.float64)
        ii2 = np.zeros_like(ii)
        ii[1:, 1:] = np.cumsum(np.cumsum(gray, 0, dtype=np.float64), 1)
        ii2[1:, 1:] = np.cumsum(np.cumsum(gray * gray, 0,
                                          dtype=np.float64), 1)

        ys, xs = np.mgrid[0:h - wh + 1:step, 0:w - ww + 1:step]
        Y, X = ys.ravel(), xs.ravel()

        def rsum(a, y0, x0, rh, rw):
            return (a[y0 + rh, x0 + rw] - a[y0, x0 + rw]
                    - a[y0 + rh, x0] + a[y0, x0])

        # variance over the 1-px-inset norm rect (cascadedetect.cpp)
        nh, nw = wh - 2, ww - 2
        n_area = float(nh * nw)
        mean = rsum(ii, Y + 1, X + 1, nh, nw) / n_area
        var = rsum(ii2, Y + 1, X + 1, nh, nw) / n_area - mean * mean
        vnorm = np.sqrt(np.maximum(var, 0.0))
        vnorm = np.where(vnorm > 0.0, vnorm, 1.0)

        inv_area = 1.0 / float(wh * ww)
        for st_thresh, sl in self.stages:
            if len(Y) == 0:
                break
            ssum = np.zeros(len(Y), np.float64)
            for k in range(sl.start, sl.stop):
                rects = self.rects[self.feat_idx[k]]
                f = np.zeros(len(Y), np.float64)
                for (rx, ry, rw, rh, wt) in rects:
                    if wt == 0.0:
                        break
                    f += wt * rsum(ii, Y + int(ry), X + int(rx),
                                   int(rh), int(rw))
                f *= inv_area
                ssum += np.where(f < self.thresh[k] * vnorm,
                                 self.left[k], self.right[k])
            keep = ssum >= st_thresh
            Y, X, vnorm = Y[keep], X[keep], vnorm[keep]
        return np.stack([Y, X], -1) if len(Y) else np.zeros((0, 2),
                                                            np.int64)

    def detect_multi_scale(self, gray: np.ndarray,
                           scale_factor: float = 1.1,
                           min_neighbors: int = 3,
                           min_size: int = 24,
                           step: int = 2) -> List[Tuple[int, int, int,
                                                        int]]:
        """(x, y, w, h) face boxes — cv2.detectMultiScale's contract."""
        from PIL import Image

        gray = np.asarray(gray, np.float64)
        h, w = gray.shape
        boxes = []
        scale = max(min_size / self.win_w, 1.0)
        while (self.win_w * scale <= w and self.win_h * scale <= h):
            sh, sw = int(round(h / scale)), int(round(w / scale))
            if sh < self.win_h or sw < self.win_w:
                break
            if (sh, sw) != (h, w):
                im = Image.fromarray(gray.astype(np.float32), mode="F")
                g = np.asarray(im.resize((sw, sh), Image.BILINEAR),
                               np.float64)
            else:
                g = gray
            for (y, x) in self._scan_scale(g, step):
                boxes.append((x * scale, y * scale,
                              self.win_w * scale, self.win_h * scale))
            scale *= scale_factor
        return group_rectangles(boxes, min_neighbors)


def group_rectangles(boxes, min_neighbors: int = 3, eps: float = 0.2):
    """OpenCV groupRectangles-style clustering: rectangles whose corners
    agree within ``eps`` of their average size vote together; clusters
    below ``min_neighbors`` votes are dropped; survivors are averaged."""
    clusters = []   # [sx, sy, sw, sh, n]
    for (x, y, w, h) in boxes:
        placed = False
        for cl in clusters:
            cx, cy, cw, ch = (cl[0] / cl[4], cl[1] / cl[4],
                              cl[2] / cl[4], cl[3] / cl[4])
            delta = eps * 0.5 * (cw + w)
            if (abs(x - cx) <= delta and abs(y - cy) <= delta
                    and abs(x + w - cx - cw) <= delta
                    and abs(y + h - cy - ch) <= delta):
                cl[0] += x
                cl[1] += y
                cl[2] += w
                cl[3] += h
                cl[4] += 1
                placed = True
                break
        if not placed:
            clusters.append([x, y, w, h, 1])
    out = []
    for sx, sy, sw, sh, n in clusters:
        if n >= min_neighbors:
            out.append((int(round(sx / n)), int(round(sy / n)),
                        int(round(sw / n)), int(round(sh / n))))
    return out


@functools.lru_cache(maxsize=4)
def load_cascade(path: str = FRONTALFACE_PATH) -> HaarCascade:
    return HaarCascade(path)


def detect_faces(img: np.ndarray, min_neighbors: int = 3,
                 min_size: int = 24) -> List[Tuple[int, int, int, int]]:
    """Grayscale-convert and run the vendored frontal-face cascade."""
    gray = (img.astype(np.float64).mean(axis=-1) if img.ndim == 3
            else img.astype(np.float64))
    return load_cascade().detect_multi_scale(gray,
                                             min_neighbors=min_neighbors,
                                             min_size=min_size)


def detect_face_center(img: np.ndarray) -> Optional[Tuple[int, int]]:
    """Center of the largest detected face — the ``img -> point | None``
    contract of pgx_torch.data.prep's detector chain."""
    faces = detect_faces(img)
    if not faces:
        return None
    x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
    return int(x + w / 2), int(y + h / 2)
