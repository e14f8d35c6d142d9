"""Process-group initialization and the rank's share of the data
(counterpart of ``pgx/parallel/distributed.py``).

``pgx`` initializes JAX's distributed runtime and lets GSPMD place the
collectives; the port runs one process per rank under a
``torch.distributed`` process group:

* ``initialize_multihost`` -> ``init_process_group`` over ``tcp://``, NCCL
  for a card and gloo for the CPU (the backend follows the device); rank r
  takes ``cuda:{r % device_count}``;
* ``broadcast_obj`` / ``broadcast_state`` -> what process 0 read from disk
  (a resumed run's configs, its full state) sent to every rank;
* ``host_batch_slice`` -> the rank's rows of a global batch;
* ``make_global_batch`` -> no assembly: each rank keeps its slice on its
  own device, and the step's collectives make the reductions global.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pgx_torch.parallel.collectives import rank, world_size
from pgx_torch.utils import resolve_device


def backend_for(device) -> str:
    """The process group backend for ``device``: NCCL for a card (raises
    when this torch has none; gloo never stands in for it), gloo for the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build; "
                               "multi-process training on a card needs it")
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> Tuple[int, int, torch.device]:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through ``tcp://{coordinator_address}`` (process 0's
    ``host:port``).  Returns ``(rank, world, device)``: ``device`` is
    ``cuda:{rank % device_count}`` (made current) for a card, the CPU
    otherwise.  With ``num_processes == 1`` nothing is initialized, as in
    ``pgx``."""
    dev = resolve_device(device)
    if num_processes == 1:
        return 0, 1, dev
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("multi-process training needs the coordinator "
                         "address, the number of processes and this "
                         "process's id")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process id {process_id} outside [0, "
                         f"{num_processes})")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(process_id)
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(backend_for(dev), init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size(), dev


def broadcast_obj(obj=None, group=None):
    """A picklable object from rank 0 to every rank (what the others pass
    is ignored).  One process: ``obj`` unchanged."""
    if world_size(group) == 1:
        return obj
    box = [obj if rank(group) == 0 else None]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def named_state_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(name, leaf)`` for every leaf of a train state or parameter tree:
    a module's parameters and buffers (its ``state_dict``), dict entries,
    list items, tensors, ``torch.Generator``s and Python scalars."""
    if isinstance(tree, torch.nn.Module):
        for k, v in tree.state_dict(keep_vars=True).items():
            yield f"{prefix}{k}", v
    elif isinstance(tree, dict):
        for k in tree:
            yield from named_state_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_state_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix.rstrip("."), tree


def _bytes_of(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t``'s bytes on ``device``."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).to(device)


def _wire_device(group, leaves) -> torch.device:
    """Where the collective's buffer lives: the current card for NCCL,
    else the first tensor leaf's device (gloo takes CPU and CUDA)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    for _, v in leaves:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def broadcast_state(state, group=None):
    """Rank 0's values of every leaf of ``state`` on every rank, in place:
    tensors (as one broadcast of their bytes), generator states and Python
    scalars.  The tree must have the same structure, shapes and dtypes on
    every rank.  Returns ``state``; one process: unchanged."""
    if world_size(group) == 1:
        return state
    leaves = list(named_state_leaves(state))
    tensors = [(n, v) for n, v in leaves if isinstance(v, torch.Tensor)]
    gens = [(n, v) for n, v in leaves if isinstance(v, torch.Generator)]
    wire = _wire_device(group, leaves)
    if tensors or gens:
        flat = torch.cat([_bytes_of(v, wire) for _, v in tensors]
                         + [_bytes_of(g.get_state(), wire) for _, g in gens])
        dist.broadcast(flat, src=0, group=group)
        lo = 0
        with torch.no_grad():
            for _, v in tensors:
                n = v.numel() * v.element_size()
                v.copy_(flat[lo:lo + n].clone().view(v.dtype).view(v.shape))
                lo += n
        for _, g in gens:
            n = g.get_state().numel()
            g.set_state(flat[lo:lo + n].cpu().clone())
            lo += n
    _set_scalars(state, broadcast_obj(_scalars(state), group))
    return state


def _scalars(tree) -> Dict[str, Any]:
    """The Python-scalar leaves of a train state, by dict path."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (bool, int, float)):
                out[k] = v
            elif isinstance(v, dict):
                sub = _scalars(v)
                if sub:
                    out[k] = sub
    return out


def _set_scalars(tree, values: Dict[str, Any]) -> None:
    for k, v in values.items():
        if isinstance(v, dict):
            _set_scalars(tree[k], v)
        else:
            tree[k] = v


def host_batch_slice(global_batch: int, group=None) -> Tuple[int, int, int]:
    """``(rank_batch, start, end)``: this rank's rows of a global batch."""
    n = world_size(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} ranks")
    per = global_batch // n
    start = rank(group) * per
    return per, start, start + per


def make_global_batch(mesh, host_arrays, device=None):
    """The rank's slice of a global batch, as it stays: each rank keeps its
    rows on its own device (no array spans the ranks, as ``pgx``'s
    ``make_array_from_process_local_data`` builds).  Numpy arrays and
    tensors are moved to ``device`` (the mesh's device when None);
    tuples, lists and dicts are walked."""
    dev = device if device is not None else mesh.devices[0]

    def put(a):
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(put(v) for v in a)
        if a is None:
            return None
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev)
    return put(host_arrays)
