"""Host-side dataset preparation tools (counterpart of ``pgx/data/prep.py``;
a copy kept here so that the port imports nothing of ``pgx``; reference
data/ directory).

* content-aware square crop — the reference scores sliding windows by SIFT
  keypoint magnitude (data/cut_to_square.py:63-103, cv2).  Without cv2's
  SIFT the default saliency is Sobel gradient energy (same mechanism:
  slide a square window, keep the highest-scoring crop); a cv2-SIFT scorer is
  used automatically when cv2 is importable.
* face-centered crop — the reference uses MTCNN (data/face_detection_tests
  .py); without a detector available we accept an externally supplied center
  point (cut_based_on_point semantics, :86-109) and fall back to the
  content-aware crop.
* metadata CSV writer (data/create_metadata.py): filename,category,size.
* filename sanitizer (data/rename_images.py): strips '&#;?'.
* checkpoint unloader (data/checkpoint_unloader.py): unzip archives into
  flat checkpoint/ and drop non-model files.
* robust image loading with the reference-complete fallback chain
  (data/utils.py:10-21): pyvips -> PIL -> cv2, each link engaging when
  its library is importable.
"""

from __future__ import annotations

import csv
import functools
import os
import zipfile
from typing import Callable, Optional, Tuple

import numpy as np


def load_image(path: str, dtype=np.uint8) -> np.ndarray:
    """Image loading with the reference's fallback chain
    (data/utils.py:10-21): pyvips (libvips sequential access — the
    README-mandated native dependency), then PIL, then cv2.  Each link is
    optional; whichever decodes first wins."""
    try:
        import pyvips
        im = pyvips.Image.new_from_file(path, access="sequential")
        arr = np.ndarray(buffer=im.write_to_memory(), dtype=np.uint8,
                         shape=(im.height, im.width, im.bands))
        if arr.shape[-1] == 1:                   # grayscale -> RGB
            arr = np.repeat(arr, 3, axis=-1)
        return arr[..., :3].astype(dtype)        # drop any alpha band
    except Exception:
        pass   # pyvips absent or failed: next link
    try:
        from PIL import Image
        im = Image.open(path)
        im.load()
        return np.asarray(im.convert("RGB"), dtype)
    except Exception:
        import cv2  # may raise ImportError; that's the end of the chain
        img = cv2.imread(path)
        if img is None:   # cv2.imread never raises — it returns None
            raise IOError(f"could not decode image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(dtype)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def _sobel_energy(gray: np.ndarray) -> np.ndarray:
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
    return np.abs(gx) + np.abs(gy)


def _saliency(img: np.ndarray) -> np.ndarray:
    """Per-pixel saliency: SIFT keypoint responses when cv2 is available
    (reference scorer), Sobel gradient energy otherwise."""
    try:
        import cv2
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        sift = cv2.SIFT_create()
        kps = sift.detect(gray, None)
        sal = np.zeros(gray.shape, np.float64)
        for kp in kps:
            x, y = int(kp.pt[0]), int(kp.pt[1])
            sal[y, x] += kp.response
        if sal.sum() > 0:
            return sal
        # no keypoints (flat/synthetic content): fall through to gradients
    except Exception:
        pass
    gray = img.astype(np.float64).mean(axis=-1)
    return _sobel_energy(gray)


def best_square_window(img: np.ndarray, stride: Optional[int] = None
                       ) -> Tuple[int, int, int]:
    """Slide a max-square window along the long axis and return
    (y0, x0, size) of the highest-saliency crop (cut_to_square.py:63-103)."""
    h, w = img.shape[:2]
    size = min(h, w)
    sal = _saliency(img)
    # integral image for O(1) window sums
    integral = np.zeros((h + 1, w + 1), np.float64)
    integral[1:, 1:] = np.cumsum(np.cumsum(sal, 0), 1)

    def window_sum(y0, x0):
        return (integral[y0 + size, x0 + size] - integral[y0, x0 + size]
                - integral[y0 + size, x0] + integral[y0, x0])

    stride = stride or max(1, size // 32)
    best, best_score = (0, 0), -1.0
    if h >= w:
        for y0 in range(0, h - size + 1, stride):
            s = window_sum(y0, 0)
            if s > best_score:
                best, best_score = (y0, 0), s
    else:
        for x0 in range(0, w - size + 1, stride):
            s = window_sum(0, x0)
            if s > best_score:
                best, best_score = (0, x0), s
    return best[0], best[1], size


def cut_to_square(img: np.ndarray) -> np.ndarray:
    """Content-aware square crop."""
    y0, x0, size = best_square_window(img)
    return img[y0:y0 + size, x0:x0 + size]


def cut_based_on_point(img: np.ndarray, cx: int, cy: int) -> np.ndarray:
    """Square crop centered (as much as bounds allow) on a point — the
    face-crop geometry (face_detection_tests.py:86-109); the point comes
    from any external detector."""
    h, w = img.shape[:2]
    size = min(h, w)
    y0 = int(np.clip(cy - size // 2, 0, h - size))
    x0 = int(np.clip(cx - size // 2, 0, w - size))
    return img[y0:y0 + size, x0:x0 + size]


@functools.lru_cache(maxsize=1)
def default_face_detector() -> Optional[Callable]:
    """Best available face detector as ``img -> (cx, cy) | None``.
    Cached: detector construction (MTCNN weight load / cascade parse) is
    far more expensive than a detect call, and cut_face resolves it per
    image when none is passed.

    Tries, in order: facenet-pytorch MTCNN (the reference's detector,
    face_detection_tests.py:12-26), the standalone ``mtcnn`` package,
    cv2's Haar cascade (pointed at the port's vendored
    ``cascades/haarcascade_frontalface_default.xml`` when ``cv2.data``
    ships no cascade files), the pure-numpy Viola-Jones engine over
    the same vendored cascade (``pgx_torch.data.haar`` — real
    trained-cascade detection with no detector library at all; the working
    leg where cv2 has no ``CascadeClassifier``), and finally the analytic
    template matcher (``pgx_torch.data.face_detect``).  Returns
    None only when even the fallbacks are unavailable (e.g. the vendored
    cascade file removed AND scipy missing) — callers then use the
    content-aware crop.  Returned detectors yield the center of the
    highest-confidence / largest face box.
    """
    try:
        from facenet_pytorch import MTCNN  # noqa: F401 (optional)
        det = MTCNN(keep_all=False)

        def facenet_detect(img: np.ndarray):
            boxes, _ = det.detect(img)
            if boxes is None or len(boxes) == 0:
                return None
            x0, y0, x1, y1 = boxes[0]
            return int((x0 + x1) / 2), int((y0 + y1) / 2)
        return facenet_detect
    except Exception:
        # not just ImportError: MTCNN() may fail at weight download /
        # torch init — fall through to the next detector either way
        pass
    try:
        from mtcnn import MTCNN  # noqa: F401 (optional)
        det = MTCNN()

        def mtcnn_detect(img: np.ndarray):
            faces = det.detect_faces(img)
            if not faces:
                return None
            x0, y0, w, h = max(faces,
                               key=lambda f: f["confidence"])["box"]
            return int(x0 + w / 2), int(y0 + h / 2)
        return mtcnn_detect
    except Exception:
        pass
    try:
        import cv2
        cascade_path = None
        try:
            cand = os.path.join(cv2.data.haarcascades,
                                "haarcascade_frontalface_default.xml")
            if os.path.exists(cand):
                cascade_path = cand
        except Exception:
            pass
        if cascade_path is None:   # cv2 without bundled cascade data:
            from pgx_torch.data.haar import FRONTALFACE_PATH
            cascade_path = FRONTALFACE_PATH   # the vendored official file
        cascade = cv2.CascadeClassifier(cascade_path)
        # CascadeClassifier does not raise on a missing/corrupt cascade
        # file — it yields an empty classifier whose detectMultiScale
        # errors at call time; treat that as "leg unavailable"
        if not cascade.empty():
            def cv2_detect(img: np.ndarray):
                gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
                faces = cascade.detectMultiScale(gray, 1.1, 4)
                if len(faces) == 0:
                    return None
                x0, y0, w, h = max(faces, key=lambda f: f[2] * f[3])
                return int(x0 + w / 2), int(y0 + h / 2)
            return cv2_detect
    except Exception:
        pass
    try:
        # pure-numpy Viola-Jones over the vendored official cascade
        # (pgx_torch/data/haar.py) — real trained-cascade detection with no
        # detector library installed; parse eagerly so a missing/corrupt
        # file falls through instead of failing at the first image
        from pgx_torch.data.haar import detect_face_center, load_cascade
        load_cascade()
        return detect_face_center
    except Exception:
        pass
    try:
        # analytic multi-scale template matcher (pgx_torch/data/face_detect.py)
        from pgx_torch.data.face_detect import detect_face
        return detect_face
    except Exception:
        return None


def cut_face(img: np.ndarray,
             detector: Optional[Callable] = None) -> np.ndarray:
    """Face-centered square crop (face_detection_tests.py:27-64): run a
    detector (any ``img -> (cx, cy) | None`` callable; defaults to the best
    installed one) and center the max-square crop on the face, falling back
    to the content-aware crop when no detector exists or no face is found —
    the reference script's manual-review path for undetected faces."""
    if detector is None:
        detector = default_face_detector()
    point = detector(img) if detector is not None else None
    if point is None:
        return cut_to_square(img)
    return cut_based_on_point(img, point[0], point[1])


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def create_metadata(image_root: str, out_csv: str) -> int:
    """Build data_info.csv with filename,category,size per image
    (data/create_metadata.py:7-30); category = subdirectory name,
    size = min(height, width)."""
    from PIL import Image
    rows = 0
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["filename", "category",
                                               "size"])
        writer.writeheader()
        for cat in sorted(os.listdir(image_root)):
            cat_dir = os.path.join(image_root, cat)
            if not os.path.isdir(cat_dir):
                continue
            for name in sorted(os.listdir(cat_dir)):
                if not name.lower().endswith(_IMG_EXTS):
                    continue
                with Image.open(os.path.join(cat_dir, name)) as im:
                    size = min(im.size)
                writer.writerow({"filename": os.path.join(cat, name),
                                 "category": cat, "size": size})
                rows += 1
    return rows


def rename_images(root: str, bad_chars: str = "&#;?") -> int:
    """Strip problem characters from filenames (data/rename_images.py)."""
    renamed = 0
    for dirpath, _, names in os.walk(root):
        for name in names:
            clean = "".join(ch for ch in name if ch not in bad_chars)
            if clean == name:
                continue
            dst = os.path.join(dirpath, clean)
            if os.path.exists(dst):
                # os.rename would silently REPLACE the existing file on
                # POSIX — pick a unique name instead of destroying data
                stem, ext = os.path.splitext(clean)
                k = 1
                while os.path.exists(os.path.join(dirpath,
                                                  f"{stem}_{k}{ext}")):
                    k += 1
                dst = os.path.join(dirpath, f"{stem}_{k}{ext}")
            os.rename(os.path.join(dirpath, name), dst)
            renamed += 1
    return renamed


def unload_checkpoints(archive_dir: str, out_dir: str) -> int:
    """Unzip checkpoint archives into a flat checkpoint/ dir and drop
    non-model files (data/checkpoint_unloader.py:6-31)."""
    ckpt_dir = os.path.join(out_dir, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    extracted = 0
    for name in sorted(os.listdir(archive_dir)):
        if not name.endswith(".zip"):
            continue
        with zipfile.ZipFile(os.path.join(archive_dir, name)) as zf:
            for member in zf.namelist():
                base = os.path.basename(member)
                if not base or not base.endswith(".model"):
                    continue
                with zf.open(member) as src, \
                        open(os.path.join(ckpt_dir, base), "wb") as dst:
                    dst.write(src.read())
                extracted += 1
    return extracted
