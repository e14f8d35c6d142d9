"""Infra helpers (counterpart of ``pgx/utils/misc.py``; the reference's
``torch_utils/misc.py``).

* ``constant``: cached tensors, one per value, shape, dtype and device;
* ``assert_shape``: shape checks with wildcards;
* ``InfiniteSampler``: rank- and replica-aware shuffling infinite index
  stream (numpy; pgx's stream for the same arguments);
* ``named_leaves`` / ``copy_params``: parameter trees by name;
* ``print_param_summary``: per-leaf path, shape, dtype and count table.

A parameter tree is a nested dict in pgx's layout (``load_params``), a
``state_dict`` (its dotted names split into the same paths) or a module (its
``state_dict``).  Leaves are named as pgx names them
(``jax.tree_util.keystr``: ``['blocks']['8']['conv1']['w']``) and listed in
its order (dict keys sorted at every level).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cached_constant(value_bytes: bytes, np_dtype: str, shape, dtype,
                     device: str) -> torch.Tensor:
    arr = np.frombuffer(value_bytes, dtype=np.dtype(np_dtype)).reshape(shape)
    return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def constant(value, shape=None, dtype=None, device="cpu") -> torch.Tensor:
    """Cached constant tensor (misc.constant): repeated calls with the same
    value, shape, dtype and device return the same tensor, so a constant is
    uploaded once.  Callers share it and must not write to it."""
    arr = np.asarray(value)
    if shape is not None:
        arr = np.broadcast_to(arr, shape)
    arr = np.ascontiguousarray(arr)
    return _cached_constant(arr.tobytes(), arr.dtype.str, arr.shape, dtype,
                            str(torch.device(device)))


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert tensor shape; ``None`` entries are wildcards
    (misc.assert_shape semantics)."""
    if x.ndim != len(ref_shape):
        raise AssertionError(
            f"wrong rank: got {x.ndim}, expected {len(ref_shape)}")
    for i, (got, want) in enumerate(zip(x.shape, ref_shape)):
        if want is None:
            continue
        if got != want:
            raise AssertionError(
                f"wrong size for dim {i}: got {got}, expected {want}")


class InfiniteSampler:
    """Rank-sharded infinite shuffling sampler (misc.InfiniteSampler):
    yields dataset indices forever, each replica seeing a disjoint
    1/num_replicas slice per pass, with optional window shuffling."""

    def __init__(self, dataset_size: int, rank: int = 0,
                 num_replicas: int = 1, shuffle: bool = True, seed: int = 0,
                 window_size: float = 0.5):
        if not (dataset_size > 0 and 0 <= rank < num_replicas):
            raise ValueError(f"need dataset_size > 0 and 0 <= rank < "
                             f"num_replicas, got {dataset_size}, {rank}, "
                             f"{num_replicas}")
        if not 0 <= window_size <= 1:
            raise ValueError(f"window_size must be in [0, 1], got "
                             f"{window_size}")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if rnd is not None and window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def _path(prefix: tuple, key) -> tuple:
    """A tree key's path: a dotted name (a state_dict's) is split."""
    return prefix + tuple(str(key).split("."))


def _keystr(path: tuple) -> str:
    return "".join(f"[{p!r}]" for p in path)


def _tree(tree):
    return tree.state_dict() if isinstance(tree, torch.nn.Module) else tree


def named_leaves(tree) -> Dict[str, Any]:
    """Flat {path: leaf} view of a parameter tree, in pgx's order."""
    leaves = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, _path(prefix, k))
            else:
                leaves.append((_path(prefix, k), v))
    walk(_tree(tree), ())
    return {_keystr(p): leaf for p, leaf in sorted(leaves,
                                                     key=lambda e: e[0])}


def _checked(name: str, src, leaf):
    if tuple(src.shape) != tuple(leaf.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                         f"{tuple(leaf.shape)}")
    return src


def copy_params(src, dst, require_all: bool = True):
    """``dst`` (a nested tree or a ``state_dict``, not changed) rebuilt with
    the leaves of ``src`` where the paths match (misc.copy_params_and_buffers;
    ``module.load_state_dict`` of the result writes a module).  A ``dst``
    leaf with no match raises KeyError under ``require_all`` and is kept
    otherwise."""
    src_flat = named_leaves(src)

    def rebuild(node, prefix):
        out = {}
        for k, v in node.items():
            path = _path(prefix, k)
            if isinstance(v, dict):
                out[k] = rebuild(v, path)
                continue
            key = _keystr(path)
            if key in src_flat:
                out[k] = _checked(key, src_flat[key], v)
            elif require_all:
                raise KeyError(key)
            else:
                out[k] = v
        return out
    return rebuild(dst, ())


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def print_param_summary(params, name: str = "params") -> str:
    """Parameter table: path, shape, dtype, count + totals
    (print_module_summary's role for parameter trees), in pgx's format."""
    rows = []
    total = 0
    for path, leaf in named_leaves(params).items():
        n = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        total += n
        rows.append((path, str(tuple(leaf.shape)), _dtype_name(leaf.dtype),
                     n))
    width = max((len(r[0]) for r in rows), default=10)
    lines = [f"{name}:"]
    for path, shape, dtype, n in rows:
        lines.append(f"  {path:<{width}}  {shape:<18} {dtype:<10} {n:>12,}")
    lines.append(f"  {'total':<{width}}  {'':<18} {'':<10} {total:>12,}")
    out = "\n".join(lines)
    print(out)
    return out
