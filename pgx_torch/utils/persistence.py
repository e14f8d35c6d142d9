"""Source snapshots of a trial (counterpart of
``pgx/utils/persistence.py:snapshot_sources``).

Checkpoints are code-free (npz arrays, a ``torch.save`` of plain tensors
and a JSON config that rebuilds the model), so what keeps a trial
reproducible is the code that produced it: at training start the port's
sources are copied into the trial directory with a manifest of sha256
content hashes, in ``pgx``'s ``MANIFEST.json`` format.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict

_SOURCE_EXTS = (".py", ".cu", ".cuh", ".h")     # Python and kernel sources


def snapshot_sources(trial_dir: str, package_root: str = None) -> str:
    """Copy the ``pgx_torch`` sources (Python and CUDA) into
    ``trial_dir/src_snapshot/pgx_torch`` and write
    ``src_snapshot/MANIFEST.json`` (relative path -> sha256); returns the
    manifest's path."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    dst_root = os.path.join(trial_dir, "src_snapshot", "pgx_torch")
    manifest: Dict[str, str] = {}
    for dirpath, _, names in os.walk(package_root):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, package_root)
        for name in sorted(names):
            if not name.endswith(_SOURCE_EXTS):
                continue
            src = os.path.join(dirpath, name)
            rel_path = os.path.normpath(os.path.join(rel, name))
            dst = os.path.join(dst_root, rel_path)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            # read once and hash the bytes written, so a concurrent edit
            # cannot leave the manifest disagreeing with the copy
            with open(src, "rb") as f:
                payload = f.read()
            with open(dst, "wb") as f:
                f.write(payload)
            shutil.copystat(src, dst)
            manifest[rel_path.replace(os.sep, "/")] = hashlib.sha256(
                payload).hexdigest()
    path = os.path.join(trial_dir, "src_snapshot", "MANIFEST.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return path
