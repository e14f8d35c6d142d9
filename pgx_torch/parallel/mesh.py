"""The data mesh (counterpart of ``pgx/parallel/mesh.py``).

``pgx`` shards the batch over a 1-D ``('data',)`` mesh of devices and
replicates the parameters; GSPMD makes every batch reduction global.  The
port's mesh is the same axis laid out over processes and devices:

* ``world`` ranks of a process group, one process per rank and one device
  per process, as training runs (``make_mesh_for_batch``): each rank holds
  ``batch / world`` rows and the train step's collectives
  (``pgx_torch.parallel.collectives``) make the reductions global;
* several devices inside one process (``make_mesh(devices)``), as the
  serving batcher and the FID extractor split one batch: each device runs
  the same forward on its rows and the rows are gathered back.

Shard ``i`` of the axis is rank ``i // len(devices)``'s device
``i % len(devices)``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from pgx_torch.parallel.collectives import rank, world_size
from pgx_torch.parallel.distributed import broadcast_state


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: this process's ``devices``, and its ``rank`` among
    the ``world`` processes of ``group`` (None: the default group, or no
    group at all when ``world`` is 1)."""

    devices: Tuple[torch.device, ...]
    world: int = 1
    rank: int = 0
    group: Any = None

    @property
    def size(self) -> int:
        """Shards along the axis: every process's devices."""
        return self.world * len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first of this process's devices."""
        return self.devices[0]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement descriptor: ``'batch'`` (rows split over the mesh) or
    ``'replicated'`` (one copy on every shard)."""

    mesh: Mesh
    kind: str


def local_devices(device="cuda") -> List[torch.device]:
    """The devices of ``device``'s type this process can use: every card,
    or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(devices: Optional[Sequence] = None, group=None) -> Mesh:
    """A mesh over ``devices`` of this process (every card when None) and
    the ranks of ``group``."""
    devs = tuple(torch.device(d) for d in (
        devices if devices is not None else local_devices()))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, world_size(group), rank(group), group)


def make_mesh_for_batch(batch_size: int, devices: Optional[Sequence] = None,
                        group=None) -> Mesh:
    """The mesh that evenly divides the global batch.

    Over several processes the world size must divide ``batch_size``
    (``ValueError`` otherwise: dropping ranks would leave processes with
    nothing to feed).  Inside one process the largest prefix of ``devices``
    that divides it is kept, with a ``RuntimeWarning`` when devices are
    dropped, as in ``pgx``."""
    devs = list(devices) if devices is not None else local_devices()
    world = world_size(group)
    n_total = world * len(devs)
    if world > 1:
        if batch_size % n_total:
            raise ValueError(
                f"batch_size={batch_size} is not divisible by the "
                f"{n_total} devices of this multi-process mesh; raise it to "
                f"a multiple of {n_total}")
        return make_mesh(devs, group)
    n = len(devs)
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n < len(devs):
        warnings.warn(
            f"batch_size={batch_size} is not divisible by the "
            f"{len(devs)} available devices; training will use only "
            f"{n} device(s). Raise batch_size to a multiple of "
            f"{len(devs)} to use the full mesh.", RuntimeWarning,
            stacklevel=2)
    return make_mesh(devs[:n], group)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Rows split over the mesh."""
    return Sharding(mesh, "batch")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, "replicated")


def _rows(x: torch.Tensor, parts: int, i: int) -> torch.Tensor:
    if x.shape[0] % parts:
        raise ValueError(f"batch {x.shape[0]} not divisible by the mesh's "
                         f"{parts} shards")
    per = x.shape[0] // parts
    return x[i * per:(i + 1) * per]


def shard_batch(mesh: Mesh, *arrays):
    """This process's rows of global batches: for each array (a tensor or
    numpy array of the whole batch), the rows of this rank, on its device;
    with several devices in this process, a list of row chunks, one on each
    device."""
    def place(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        mine = _rows(t, mesh.world, mesh.rank)
        parts = [_rows(mine, len(mesh.devices), j).to(d)
                 for j, d in enumerate(mesh.devices)]
        return parts[0] if len(parts) == 1 else parts
    out = tuple(place(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """The same ``tree`` (a module, a train state) on every shard: rank 0's
    values broadcast to every rank, in place; with several devices in this
    process, a list of copies, one on each device (the first is ``tree``
    itself when it already lives there)."""
    if mesh.world > 1:
        broadcast_state(tree, mesh.group)
    if len(mesh.devices) == 1:
        return tree
    return [_copy_to(tree, d) for d in mesh.devices]


def _copy_to(tree, device: torch.device):
    if isinstance(tree, torch.nn.Module):
        first = next(iter(tree.parameters()), None)
        if first is not None and first.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    return tree


def data_parallel_apply(mesh: Mesh, fn: Callable, replicas: Sequence,
                        *arrays):
    """One batch split over this process's devices and gathered back:
    ``fn(replicas[j], *rows_j)`` on device j for row chunk j of every
    array (None stays None), each enqueued without waiting, and the outputs
    concatenated on the first device.  The batch must divide into
    ``len(mesh.devices)`` chunks."""
    n = len(mesh.devices)
    outs = []
    for j, dev in enumerate(mesh.devices):
        rows = [None if a is None
                else _rows(a, n, j).to(dev, non_blocking=True)
                for a in arrays]
        # a kernel launches on the current device's stream
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(fn(replicas[j], *rows))
    return torch.cat([o.to(mesh.device, non_blocking=True) for o in outs])
