"""Source snapshots of a trial (counterpart of ``pgx/utils/persistence.py``:
``snapshot_sources``, ``restore_from_snapshot``, ``verify_snapshot``).

Checkpoints are code-free (npz arrays, a ``torch.save`` of plain tensors
and a JSON config that rebuilds the model), so what keeps a trial
reproducible is the code that produced it: at training start the port's
sources are copied into the trial directory with a manifest of sha256
content hashes, in ``pgx``'s ``MANIFEST.json`` format.  A snapshot is
restored as an importable ``pgx_torch`` package root (after its files are
checked against the manifest), or compared with the package imported now.
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
        package_root = _package_root()
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


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_manifest(trial_dir: str) -> Dict[str, str]:
    with open(os.path.join(trial_dir, "src_snapshot", "MANIFEST.json")) as f:
        return json.load(f)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def restore_from_snapshot(trial_dir: str, dest: str = None,
                          verify: bool = True) -> str:
    """Materialize a trial's exact ``pgx_torch`` sources from its
    ``src_snapshot`` as an importable package root; returns the directory
    to put on ``sys.path`` / ``PYTHONPATH``.  Use it from a fresh
    interpreter (a package already imported is not swapped):

        root = restore_from_snapshot(trial_dir)
        subprocess.run([sys.executable, "-m", "pgx_torch.cli.generate",
                        ...], env={**os.environ, "PYTHONPATH": root})

    With ``verify`` (the default) every snapshot file is checked against
    the manifest's sha256 first, and a file the manifest does not list
    counts as tampering too: a mismatch raises ValueError instead of
    reviving wrong code."""
    snap_root = os.path.join(trial_dir, "src_snapshot")
    pkg_root = os.path.join(snap_root, "pgx_torch")
    manifest = _read_manifest(trial_dir)
    if verify:
        bad = {}
        for rel, digest in manifest.items():
            src = os.path.join(pkg_root, rel)
            if not os.path.exists(src):
                bad[rel] = "missing"
            elif _sha256(src) != digest:
                bad[rel] = "corrupt"
        for dirpath, _, names in os.walk(pkg_root):
            if "__pycache__" in dirpath:     # never restored
                continue
            for name in names:
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      pkg_root).replace(os.sep, "/")
                if rel not in manifest:
                    bad[rel] = "unlisted"
        if bad:
            raise ValueError(
                f"snapshot in {trial_dir} fails manifest verification: "
                f"{bad}")
    dest = dest or os.path.join(trial_dir, "restored_src")
    dst_pkg = os.path.join(dest, "pgx_torch")
    if os.path.exists(dst_pkg):
        shutil.rmtree(dst_pkg)
    shutil.copytree(pkg_root, dst_pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def verify_snapshot(trial_dir: str) -> Dict[str, str]:
    """Compare the snapshot's manifest with the ``pgx_torch`` imported now;
    returns {relpath: 'changed' | 'missing'} for any drift (empty: the
    same sources)."""
    package_root = _package_root()
    drift: Dict[str, str] = {}
    for rel, digest in _read_manifest(trial_dir).items():
        src = os.path.join(package_root, rel)
        if not os.path.exists(src):
            drift[rel] = "missing"
        elif _sha256(src) != digest:
            drift[rel] = "changed"
    return drift
