"""Dataset preparation CLI (counterpart of ``pgx/cli/prepare_data.py``;
mirrors the reference's data/ scripts).  Host-only: numpy, PIL and, where
installed, cv2, pyvips or MTCNN.

Subcommands:
  square    content-aware square crop of every image (data/cut_to_square.py)
  facecrop  point-centered square crop (data/face_detection_tests.py crop
            geometry; the reference's MTCNN face *detector* is not bundled —
            supply detector output via --points-csv, or pass --use-mtcnn to
            use facenet-pytorch's MTCNN when it is installed)
  metadata  build data_info.csv (data/create_metadata.py)
  rename    strip problem characters from filenames (data/rename_images.py)
  unload    unzip checkpoint archives (data/checkpoint_unloader.py)
"""

from __future__ import annotations

import argparse
import os

from pgx_torch.data import prep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sq = sub.add_parser("square", help="content-aware square crop")
    sq.add_argument("--src", required=True)
    sq.add_argument("--dst", required=True)

    fc = sub.add_parser(
        "facecrop",
        help="face-detected square crop (detector chain or explicit points)",
        description="Reproduces the face-centered crop of the reference's "
                    "data/face_detection_tests.py. By default each image "
                    "runs through the detector chain "
                    "(pgx_torch.data.prep.default_face_detector: MTCNN when "
                    "installed, else the bundled Haar cascade via the "
                    "numpy Viola-Jones engine); images with no detection "
                    "are skipped and counted.  --points-csv (columns: "
                    "filename,cx,cy) overrides with external detector "
                    "output; --use-mtcnn forces facenet-pytorch.")
    fc.add_argument("--src", required=True)
    fc.add_argument("--dst", required=True)
    fc.add_argument("--points-csv",
                    help="CSV with filename,cx,cy detector output (filename "
                         "is the src-relative path for nested dirs)")
    fc.add_argument("--use-mtcnn", action="store_true",
                    help="force facenet-pytorch MTCNN (optional dependency) "
                         "instead of the default detector chain")

    md = sub.add_parser("metadata", help="build data_info.csv")
    md.add_argument("--root", required=True)
    md.add_argument("--out", default="data_info.csv")

    rn = sub.add_parser("rename", help="sanitize filenames")
    rn.add_argument("--root", required=True)

    ul = sub.add_parser("unload", help="unzip checkpoint archives")
    ul.add_argument("--archives", required=True)
    ul.add_argument("--out", required=True)

    args = p.parse_args(argv)

    if args.cmd == "square":
        os.makedirs(args.dst, exist_ok=True)
        n = 0
        for dirpath, _, names in os.walk(args.src):
            rel = os.path.relpath(dirpath, args.src)
            for name in names:
                if not name.lower().endswith(prep._IMG_EXTS):
                    continue
                img = prep.load_image(os.path.join(dirpath, name))
                out_dir = os.path.join(args.dst, rel)
                os.makedirs(out_dir, exist_ok=True)
                prep.save_image(os.path.join(out_dir, name),
                                prep.cut_to_square(img))
                n += 1
        print(f"cropped {n} images")
    elif args.cmd == "facecrop":
        points = {}
        if args.points_csv:
            import csv
            with open(args.points_csv, newline="") as f:
                for row in csv.DictReader(f):
                    points[row["filename"]] = (int(float(row["cx"])),
                                               int(float(row["cy"])))
        detector = None
        if args.use_mtcnn:
            try:
                from facenet_pytorch import MTCNN  # optional dependency
            except ImportError:
                p.error("--use-mtcnn requires facenet-pytorch, which is not "
                        "installed in this environment; run the detector "
                        "elsewhere and pass --points-csv instead")
            detector = MTCNN(select_largest=True)
        default_det = None
        if not points and detector is None:
            # the always-available chain: MTCNN when installed, else the
            # vendored Haar cascade through the numpy Viola-Jones engine
            default_det = prep.default_face_detector()
            if default_det is None:
                p.error("facecrop: no detector available and no "
                        "--points-csv given (see --help)")
        os.makedirs(args.dst, exist_ok=True)
        n = skipped = 0
        for dirpath, _, names in os.walk(args.src):
            rel = os.path.relpath(dirpath, args.src)
            for name in names:
                if not name.lower().endswith(prep._IMG_EXTS):
                    continue
                img = prep.load_image(os.path.join(dirpath, name))
                # points are keyed by src-relative path (equals the bare
                # filename for flat datasets) — a bare-name lookup for
                # nested dirs would silently share one point between
                # same-named files in different subdirectories
                rel_name = name if rel == "." else os.path.join(rel, name)
                if rel_name in points:
                    cx, cy = points[rel_name]
                elif detector is not None:
                    boxes, _ = detector.detect(img)
                    if boxes is None or len(boxes) == 0:
                        skipped += 1
                        continue
                    x0, y0, x1, y1 = boxes[0]
                    cx, cy = int((x0 + x1) / 2), int((y0 + y1) / 2)
                elif default_det is not None:
                    pt = default_det(img)
                    if pt is None:
                        skipped += 1
                        continue
                    cx, cy = pt
                else:
                    skipped += 1
                    continue
                out_dir = os.path.join(args.dst, rel)
                os.makedirs(out_dir, exist_ok=True)
                prep.save_image(os.path.join(out_dir, name),
                                prep.cut_based_on_point(img, cx, cy))
                n += 1
        print(f"cropped {n} images ({skipped} skipped: no detection/point)")
    elif args.cmd == "metadata":
        n = prep.create_metadata(args.root, args.out)
        print(f"wrote {args.out} ({n} rows)")
    elif args.cmd == "rename":
        n = prep.rename_images(args.root)
        print(f"renamed {n} files")
    elif args.cmd == "unload":
        n = prep.unload_checkpoints(args.archives, args.out)
        print(f"extracted {n} model files")


if __name__ == "__main__":
    main()
