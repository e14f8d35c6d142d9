"""The step-indexed store of the full train state (counterpart of
``pgx/checkpoint/orbax_backend.py``).

pgx's ``checkpoint_backend='orbax'`` keeps the full train state in an orbax
``CheckpointManager``: the device-to-host copy is synchronous, the write
runs in a background thread, each step commits atomically into its own
directory.  orbax is a JAX library, so the port has its own store with that
contract, over the same ``torch.save`` payload as ``{iter}_state.pt``
(``pgx_torch.checkpoint.state_payload``); neither package reads the other's.
Like pgx's backend it replaces only the full state: the ``{iter}_g.model``
and ``_d.model`` npz pair is written whatever the backend.

    {trial}/step_state/{iter}.tmp/state.pt   being written
    {trial}/step_state/{iter}/state.pt       committed (atomic rename)

``save`` copies the state to the host before it returns (into pinned memory
on the card, one synchronization), so training may change the state at
once; the write and the commit run in a thread.  At most one write is in
flight: a ``save`` first waits for the one before.  ``latest_iteration``
sees committed steps only.  An error in the writer is raised again by the
next ``save``, ``wait`` or ``close``, never dropped.

Select with ``LoopConfig(checkpoint_backend="orbax")`` or
``--checkpoint-backend orbax`` on any training CLI: the value keeps pgx's
name, so trial configs stay comparable.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from pgx_torch import checkpoint as ckpt

STORE_DIRNAME = "step_state"
STATE_FILE = "state.pt"


def _to_host(obj):
    """``obj`` with every tensor copied to the host: into pinned memory
    without waiting for a CUDA tensor (the caller synchronizes once), a
    clone for a CPU tensor."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    return obj


def _committed(root: str):
    """The iterations committed under ``root``, in order."""
    if not os.path.isdir(root):
        return []
    return sorted(int(n) for n in os.listdir(root)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(root, n, STATE_FILE)))


class StepStateStore:
    """Step-indexed store for the full train state of one trial; with
    ``async_save`` the writes run in a background thread."""

    def __init__(self, trial_dir: str, async_save: bool = True):
        self.root = os.path.abspath(os.path.join(trial_dir, STORE_DIRNAME))
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.root, exist_ok=True)

    def _write(self, iteration: int, payload: Dict[str, Any]) -> None:
        tmp = os.path.join(self.root, f"{iteration}.tmp")
        final = os.path.join(self.root, str(iteration))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):       # the same step saved again
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)

    def _run(self, iteration: int, payload: Dict[str, Any]) -> None:
        try:
            self._write(iteration, payload)
        except BaseException as e:      # kept for the caller's next call
            self._error = e

    def save(self, iteration: int, state: Dict[str, Any]) -> None:
        """Copy ``state`` to the host, then write it as step ``iteration``
        (in the background with ``async_save``)."""
        self.wait()
        payload = _to_host(ckpt.state_payload(state))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if not self.async_save:
            self._write(iteration, payload)
            return
        self._thread = threading.Thread(
            target=self._run, args=(iteration, payload),
            name=f"step-state-{iteration}", daemon=True)
        self._thread.start()

    def restore(self, iteration: int, state: Dict[str, Any]
                ) -> Dict[str, Any]:
        """Restore committed step ``iteration`` into ``state`` (in place;
        returned), tensors on the device of the state's modules."""
        self.wait()
        path = os.path.join(self.root, str(iteration), STATE_FILE)
        saved = torch.load(path, map_location=ckpt.state_device(state),
                           weights_only=True)
        return ckpt.apply_state_payload(saved, state, path)

    def latest_iteration(self) -> Optional[int]:
        """The newest committed step, or None."""
        steps = _committed(self.root)
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the pending write is committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def has_step_state(trial_dir: str) -> bool:
    """Whether ``trial_dir`` holds a committed step of the store."""
    return bool(_committed(os.path.join(trial_dir, STORE_DIRNAME)))
