"""``pgx``'s trial-directory protocol: checkpoints, configs, the grower.

Counterpart of ``pgx/checkpoint/__init__.py``.  A trial directory holds

* ``checkpoint/{iter:03d}_g.model`` (the EMA generator) and
  ``{iter:03d}_d.model`` (the discriminator): flattened-key ``.npz``
  params trees in ``pgx``'s key names, each array in its own dtype, so
  either package reads the other's;
* ``checkpoint/{iter:03d}_state.pt``: the full train state (both modules
  and the EMA, both Adam states, ``iteration``, the ADA controller and the
  loop's random generator), written with ``torch.save`` of plain
  containers and read with ``weights_only=True``.  ``pgx`` writes its full
  state as ``*_state.msgpack`` (flax); neither package reads the other's,
  and each falls back to the npz pair;
* ``train_config_*.json``: the three configs and the run's recipe, the
  same keys as ``pgx``'s.

``load_params`` returns nested dicts of numpy arrays in ``pgx``'s layout,
which ``Generator.from_jax_params`` loads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig

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


def params_tree(module: torch.nn.Module) -> Params:
    """A module's parameters as a nested dict of numpy arrays in ``pgx``'s
    layout (``blocks.8.conv1.w`` -> ``{"blocks": {"8": {"conv1": {"w":
    ...}}}}``), each in the parameter's own dtype."""
    tree: Params = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# Full train state (torch.save of plain containers)
# ---------------------------------------------------------------------------

_MODULES = ("g", "d", "g_ema")
_OPTS = ("opt_g", "opt_d")


def state_payload(state: Dict[str, Any]) -> Dict[str, Any]:
    """The full train state as plain containers, what ``save_state``
    writes: each module's ``state_dict``, the Adam ``count``/``mu``/``nu``,
    ``iteration``, ``ada`` and, when the state holds one under ``rng``, the
    random generator's state.  Its tensors are the state's own (no
    copy)."""
    out: Dict[str, Any] = {k: state[k].state_dict() for k in _MODULES}
    for k in _OPTS:
        opt = state[k]
        out[k] = {"count": int(opt["count"]), "mu": dict(opt["mu"]),
                  "nu": dict(opt["nu"])}
    out["iteration"] = int(state["iteration"])
    out["ada"] = dict(state["ada"])
    if state.get("rng") is not None:
        out["rng"] = state["rng"].get_state()
    return out


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Write the full train state (``state_payload``) with ``torch.save``."""
    torch.save(state_payload(state), path)


def apply_state_payload(saved: Dict[str, Any], state: Dict[str, Any],
                        source: str) -> Dict[str, Any]:
    """Restore a ``state_payload`` into ``state`` (in place; returned): the
    modules keep their parameter objects, a generator under ``rng`` takes
    the saved state.  ``source`` names the file in errors."""
    for k in _MODULES:
        state[k].load_state_dict(saved[k], strict=True)
    for k in _OPTS:
        opt = state[k]
        for moment in ("mu", "nu"):
            if saved[k][moment].keys() != opt[moment].keys():
                raise ValueError(f"{source}: {k}.{moment} does not match "
                                 f"the parameters")
        state[k] = {"count": int(saved[k]["count"]),
                    "mu": dict(saved[k]["mu"]), "nu": dict(saved[k]["nu"])}
    state["iteration"] = int(saved["iteration"])
    state["ada"] = dict(saved["ada"])
    if "rng" in saved and state.get("rng") is not None:
        state["rng"].set_state(saved["rng"].cpu())
    return state


def state_device(state: Dict[str, Any]) -> torch.device:
    """The device of the state's modules."""
    return next(state["g"].parameters()).device


def load_state(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a ``save_state`` file into ``state`` (in place; returned):
    tensors land on the device of the state's modules."""
    saved = torch.load(path, map_location=state_device(state),
                       weights_only=True)
    return apply_state_payload(saved, state, path)


# ---------------------------------------------------------------------------
# Trial directory protocol
# ---------------------------------------------------------------------------

def checkpoint_name(iteration: int, kind: str) -> str:
    """'{iter+0:03d}_g.model' naming (zero-padded to >= 3 digits)."""
    return f"{str(iteration).zfill(3)}_{kind}.model"


def save_checkpoint(trial_dir: str, iteration: int, state: Dict[str, Any],
                    full_state: bool = True) -> None:
    """``{iter:03d}_g.model`` (the EMA generator) and ``_d.model``, and with
    ``full_state`` also ``{iter:03d}_state.pt``."""
    ckpt = os.path.join(trial_dir, "checkpoint")
    os.makedirs(ckpt, exist_ok=True)
    save_params(os.path.join(ckpt, checkpoint_name(iteration, "g")),
                params_tree(state["g_ema"]))
    save_params(os.path.join(ckpt, checkpoint_name(iteration, "d")),
                params_tree(state["d"]))
    if full_state:
        save_state(os.path.join(ckpt, state_name(iteration)), state)


def state_name(iteration: int) -> str:
    """'{iter:03d}_state.pt', the full state's file name."""
    return f"{str(iteration).zfill(3)}_state.pt"


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

def save_config(trial_dir: str, gcfg: GeneratorConfig,
                dcfg: DiscriminatorConfig, tc,
                extra: Optional[Dict[str, Any]] = None,
                postfix: str = "") -> str:
    """``train_config_{postfix}.json``: the three configs under
    ``generator``, ``discriminator`` and ``train``, plus ``extra``."""
    cfg = {
        "generator": dataclasses.asdict(gcfg),
        "discriminator": dataclasses.asdict(dcfg),
        "train": dataclasses.asdict(tc),
        **(extra or {}),
    }
    os.makedirs(trial_dir, exist_ok=True)
    path = os.path.join(trial_dir, f"train_config_{postfix}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


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


def configs_from_dict(cfg: Dict[str, Any]):
    """``(GeneratorConfig, DiscriminatorConfig, TrainConfig)`` of a trial
    config; a missing ``train`` section gives the defaults."""
    from pgx_torch.train.wgan import TrainConfig
    d = dict(cfg["discriminator"])
    for k in ("stage_in", "stage_out"):
        if k in d:
            d[k] = tuple(d[k])
    return (generator_config_from_dict(cfg), DiscriminatorConfig(**d),
            TrainConfig(**cfg.get("train", {})))


# ---------------------------------------------------------------------------
# Smaller -> bigger checkpoint grower
# ---------------------------------------------------------------------------

def grow_params(small: Params, big: Params, decay: float = 0.0) -> Params:
    """Copy every matching-path leaf of the numpy tree ``small`` into
    ``big``.  Params are keyed by resolution, so one key match is both the
    generator's by-name copy and the discriminator's "align from the end".
    ``decay`` blends: new = decay * big + (1 - decay) * small."""
    def rec(s, b):
        if isinstance(b, dict):
            return {k: rec(s[k], v) if isinstance(s, dict) and k in s else v
                    for k, v in b.items()}
        if s.shape != b.shape:
            raise ValueError(f"shape mismatch {s.shape} vs {b.shape}")
        return decay * b + (1.0 - decay) * s
    return rec(small, big)


def assert_grow_equivalence(small_params, small_cfg, big_params, big_cfg,
                            z, labels=None, step: int = 1,
                            atol: float = 1e-5, device="cuda") -> None:
    """The grown generator must produce the small one's images at the
    shared ``step`` (``z``, ``labels``: numpy arrays)."""
    from pgx_torch.models.generator import Generator
    outs = []
    for params, cfg in ((small_params, small_cfg), (big_params, big_cfg)):
        gen = Generator.from_jax_params(cfg, params, device)
        with torch.no_grad():
            outs.append(gen(*_tensors(z, labels, gen), step=step))
    np.testing.assert_allclose(*(o.float().cpu().numpy() for o in outs),
                               atol=atol, rtol=1e-5)


def assert_grow_equivalence_d(small_params, small_cfg, big_params, big_cfg,
                              img, labels=None, step: int = 1,
                              atol: float = 1e-5, device="cuda") -> None:
    """The grown discriminator must score a shared-step image (NHWC numpy)
    as the small one does."""
    from pgx_torch.models.discriminator import Discriminator
    outs = []
    for params, cfg in ((small_params, small_cfg), (big_params, big_cfg)):
        disc = Discriminator.from_jax_params(cfg, params, device)
        with torch.no_grad():
            outs.append(disc(*_tensors(img, labels, disc), step=step))
    np.testing.assert_allclose(*(o.float().cpu().numpy() for o in outs),
                               atol=atol, rtol=1e-5)


def _tensors(x, labels, module: torch.nn.Module):
    device = next(module.parameters()).device
    return (torch.as_tensor(np.asarray(x), device=device),
            None if labels is None
            else torch.as_tensor(np.asarray(labels), device=device))
