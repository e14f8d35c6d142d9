"""Absolute-FID certification (counterpart of ``pgx/cli/fid_selftest.py``).

    python -m pgx_torch.cli.fid_selftest --weights /path/to/weights.pth

Identifies the weights file by its sha256 against the two official
checkpoints the reference accepts (pytorch_fid's ``pt_inception-2015-12-05``
and torchvision's ``inception_v3``; the torch-hub filename suffix is the
first 8 hex digits of the sha256), computes the pool3 activations and the
half-against-half FID of the committed 64-image set
(``pgx_torch/eval/selftest_images.npz``) on ``--device``, and compares them
with the recorded slot (``pgx_torch/eval/selftest_expected.json``).  Exit
codes: 0 pass (or computed and reported when the slot is empty), 1 a value
does not match, 2 the weights file is not recognised.

``--update-expected`` records the computed values in the slot: run it once
with a verified official file and commit the JSON, and every later run
certifies the preprocessing, Inception and Frechet chain in one command.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

_EVAL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "eval")
IMAGES_PATH = os.path.join(_EVAL_DIR, "selftest_images.npz")
EXPECTED_PATH = os.path.join(_EVAL_DIR, "selftest_expected.json")

# the chain is deterministic per (weights, device, library version);
# another platform's summation order moves pool3 means by ~1e-5 and the
# small set's FID by well under 0.1% relative
RTOL = 1e-3


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def identify_weights(sha: str, expected: dict):
    """The slot whose ``sha256_prefix`` starts the file's hash, or None."""
    for name, slot in expected.items():
        if name.startswith("_"):
            continue
        prefix = slot.get("sha256_prefix")
        if prefix and sha.startswith(prefix):
            return name
    return None


def compute_selftest_values(weights_path: str, batch_size: int = 16,
                            device="cuda"):
    """Pool3 activations and the half-against-half FID of the committed
    image set."""
    from pgx_torch.eval.fid import (calculate_frechet_distance,
                                    get_activations, make_extractor)
    from pgx_torch.eval.inception import load_torch_weights

    images = np.load(IMAGES_PATH)["images"]
    extractor = make_extractor(load_torch_weights(weights_path),
                               device=device)
    acts = get_activations(images, extractor, batch_size=batch_size)
    half = len(acts) // 2
    a, b = acts[:half], acts[half:]
    fid = calculate_frechet_distance(
        np.mean(a, axis=0), np.cov(a, rowvar=False),
        np.mean(b, axis=0), np.cov(b, rowvar=False))
    return {
        "fid_halves": float(fid),
        "act_mean_abs": float(np.mean(np.abs(acts))),
        "act_mean": float(np.mean(acts)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", default=os.environ.get(
        "PGX_INCEPTION_WEIGHTS"),
        help="torch state_dict file (pt_inception-2015-12-05 or "
             "torchvision inception_v3 layout); defaults to "
             "$PGX_INCEPTION_WEIGHTS")
    p.add_argument("--expected", default=EXPECTED_PATH,
                   help="expected-value json (default: the committed "
                        "pgx_torch/eval/selftest_expected.json)")
    p.add_argument("--allow-unverified", action="store_true",
                   help="score even when the file's sha256 matches no "
                        "known official checkpoint (reported, never "
                        "compared or recorded)")
    p.add_argument("--update-expected", action="store_true",
                   help="record the computed values into the identified "
                        "slot of the expected json")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device for Inception (default: cuda)")
    args = p.parse_args(argv)

    if not args.weights:
        p.error("--weights (or $PGX_INCEPTION_WEIGHTS) is required")
    if not os.path.exists(args.weights):
        p.error(f"weights file not found: {args.weights}")

    with open(args.expected) as f:
        expected = json.load(f)

    sha = sha256_file(args.weights)
    slot_name = identify_weights(sha, expected)
    if slot_name is None and not args.allow_unverified:
        print(json.dumps({
            "status": "unrecognized_weights", "sha256": sha,
            "known": {k: v["sha256_prefix"] for k, v in expected.items()
                      if not k.startswith("_")},
            "hint": "pass --allow-unverified to score anyway (values will "
                    "not be comparable to the reference scale)"}))
        return 2

    values = compute_selftest_values(args.weights, args.batch_size,
                                     args.device)

    status = "computed_unverified"
    mismatches = {}
    if slot_name is not None:
        slot = expected[slot_name]
        if args.update_expected:
            slot.update(values)
            with open(args.expected, "w") as f:
                json.dump(expected, f, indent=2)
            status = "expected_recorded"
        elif slot.get("fid_halves") is None:
            status = "computed_no_expected"
        else:
            for k, got in values.items():
                want = slot.get(k)
                if want is None:
                    continue
                if abs(got - want) > RTOL * max(abs(want), 1e-12):
                    mismatches[k] = {"got": got, "want": want}
            status = "fail" if mismatches else "pass"

    print(json.dumps({
        "status": status, "weights": slot_name or "unverified",
        "sha256": sha, **values,
        **({"mismatches": mismatches} if mismatches else {}),
        **({"hint": "run once with --update-expected on a machine with "
                    "the official weights to record the expected values"}
           if status == "computed_no_expected" else {}),
    }))
    return 1 if status == "fail" else 0


if __name__ == "__main__":
    sys.exit(main())
