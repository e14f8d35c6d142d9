"""The read side of ``pgx``'s trial-directory protocol.

Counterpart of ``pgx/checkpoint/__init__.py``: a trial directory holds
``train_config_*.json`` and ``checkpoint/{iter:03d}_g.model`` files, which
are flattened-key ``.npz`` params trees (framework-neutral, no pickles).
``load_params`` returns nested dicts of numpy arrays in ``pgx``'s layout,
which ``Generator.from_jax_params`` loads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from pgx_torch.models.config import GeneratorConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Flat npz param files
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def save_params(path: str, params: Params) -> None:
    # write through a file object: np.savez would append '.npz' to the
    # reference-style '*_g.model' filenames otherwise
    with open(path, "wb") as f:
        np.savez(f, **_flatten(params))


def load_params(path: str) -> Params:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# Trial directory protocol
# ---------------------------------------------------------------------------

def checkpoint_name(iteration: int, kind: str) -> str:
    """'{iter+0:03d}_g.model' naming (zero-padded to >= 3 digits)."""
    return f"{str(iteration).zfill(3)}_{kind}.model"


def checkpoint_iteration(path: str) -> int:
    """Leading iteration index from a checkpoint filename."""
    return int(os.path.basename(path).split("_")[0])


def list_checkpoints(trial_dir: str, kind: str = "g"):
    ckpt = os.path.join(trial_dir, "checkpoint")
    if not os.path.isdir(ckpt):
        return []

    def _numeric(name: str) -> bool:
        # a stray hand-named copy (best_g.model) must not break every
        # checkpoint consumer for the whole trial
        try:
            checkpoint_iteration(name)
            return True
        except ValueError:
            return False

    names = [n for n in os.listdir(ckpt)
             if n.endswith(f"_{kind}.model") and _numeric(n)]
    names.sort(key=checkpoint_iteration)
    return [os.path.join(ckpt, n) for n in names]


def latest_checkpoint(trial_dir: str, kind: str = "g") -> Optional[str]:
    paths = list_checkpoints(trial_dir, kind)
    return paths[-1] if paths else None


def resolve_checkpoint(trial_dir: str, checkpoint: Optional[int] = None,
                       kind: str = "g") -> str:
    """Pin-or-latest checkpoint path: an explicit ``checkpoint`` iteration
    must exist, otherwise the newest ``*_{kind}.model`` wins.  Raises
    FileNotFoundError either way."""
    if checkpoint is not None:
        path = os.path.join(trial_dir, "checkpoint",
                            checkpoint_name(int(checkpoint), kind))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint {checkpoint} in {trial_dir}")
        return path
    path = latest_checkpoint(trial_dir, kind)
    if path is None:
        raise FileNotFoundError(
            f"no *_{kind}.model checkpoints in {trial_dir}")
    return path


def load_generator_state(trial_dir: str, schedule,
                         checkpoint: Optional[int] = None,
                         path: Optional[str] = None):
    """Resolve the pin-or-latest ``*_g.model``, load its params and
    re-derive the growth state from the iteration index.  A checkpoint
    written at iteration N was saved after step N ran, so the growth state
    is ``schedule.state_at(N - 1)``.

    Returns ``(gpath, params, iteration, state)``; ``state`` is None when
    ``schedule`` is None."""
    gpath = path if path is not None else resolve_checkpoint(
        trial_dir, checkpoint, "g")
    params = load_params(gpath)
    iteration = checkpoint_iteration(gpath)
    state = (schedule.state_at(max(iteration - 1, 0))
             if schedule is not None else None)
    return gpath, params, iteration, state


# ---------------------------------------------------------------------------
# Config JSON
# ---------------------------------------------------------------------------

def load_config(trial_dir: str) -> Dict[str, Any]:
    """Find and parse the trial's train_config_*.json."""
    names = [n for n in os.listdir(trial_dir)
             if n.startswith("train_config") and n.endswith(".json")]
    if not names:
        raise FileNotFoundError(f"no train_config_*.json in {trial_dir}")
    with open(os.path.join(trial_dir, sorted(names)[0])) as f:
        return json.load(f)


def generator_config_from_dict(cfg: Dict[str, Any]) -> GeneratorConfig:
    """The ``generator`` section of a trial config as a GeneratorConfig
    (the discriminator and train sections are not read)."""
    g = dict(cfg["generator"])
    if "channels" in g:
        g["channels"] = tuple(g["channels"])
    return GeneratorConfig(**g)
