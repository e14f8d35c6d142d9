"""Cross-process training statistics (counterpart of
``pgx/parallel/stats.py``; the reference's ``training_stats``).

A statistic is a moment vector ``[n, sum(x), sum(x^2)]`` (a (3,) float32
tensor) that lives wherever the caller keeps it; ``psum_moments`` sums it
over the ranks (the reference's ``all_reduce`` on sync), and the host-side
``Collector`` reads the mean and std over each update window.
``check_replica_consistency`` holds every rank's copy of a replicated
state against rank 0's.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from pgx_torch.parallel.collectives import first_rank, rank, world_size
from pgx_torch.parallel.distributed import (_bytes_of, _wire_device,
                                            broadcast_obj, named_state_leaves)

Moments = torch.Tensor   # shape (3,): [num, sum(x), sum(x^2)]


def init_moments(device="cpu") -> Moments:
    return torch.zeros((3,), dtype=torch.float32, device=device)


def report(moments: Moments, value) -> Moments:
    """Accumulate a tensor of samples into a moment vector."""
    x = torch.as_tensor(value, dtype=torch.float32,
                        device=moments.device).reshape(-1)
    return moments + torch.stack([
        torch.tensor(float(x.numel()), device=moments.device),
        torch.sum(x), torch.sum(torch.square(x))])


def psum_moments(moments: Moments, group=None) -> Moments:
    """The moments summed over the ranks of ``group`` (one process:
    unchanged).  ``pgx`` needs this only inside shard_map bodies; the
    port's ranks are processes, so every cross-rank statistic takes it."""
    if world_size(group) == 1:
        return moments
    out = moments.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def mean(moments) -> float:
    m = np.asarray(torch.as_tensor(moments).cpu(), np.float64)
    return float(m[1] / m[0]) if m[0] > 0 else float("nan")


def std(moments) -> float:
    m = np.asarray(torch.as_tensor(moments).cpu(), np.float64)
    if m[0] <= 0:
        return float("nan")
    mu = m[1] / m[0]
    var = max(m[2] / m[0] - mu * mu, 0.0)
    return float(np.sqrt(var))


class Collector:
    """Host-side stat windows: ``update(named_moments)`` folds a new
    snapshot of cumulative moments in; ``mean``/``std`` read the delta
    since the previous update."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._cumulative: Dict[str, np.ndarray] = {}
        self._delta: Dict[str, np.ndarray] = {}

    def names(self):
        return sorted(self._delta)

    def update(self, named_moments: Dict[str, Moments]) -> None:
        seen = set()
        for name, m in named_moments.items():
            if not self._regex.fullmatch(name):
                continue
            cur = np.asarray(torch.as_tensor(m).cpu(), np.float64)
            prev = self._cumulative.get(name, np.zeros(3))
            if cur[0] < prev[0]:
                # the cumulative count dropped: the moments were
                # re-initialized, so the whole snapshot is this window's
                prev = np.zeros(3)
            self._delta[name] = cur - prev
            self._cumulative[name] = cur
            seen.add(name)
        # a stat absent from this snapshot contributed nothing this window
        for name in self._delta:
            if name not in seen:
                self._delta[name] = np.zeros(3)

    def num(self, name: str) -> int:
        return int(self._delta.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        return mean(self._delta.get(name, np.zeros(3)))

    def std(self, name: str) -> float:
        return std(self._delta.get(name, np.zeros(3)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"num": self.num(n), "mean": self.mean(n),
                    "std": self.std(n)} for n in self.names()}


def _leaf_diff(mine: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The largest |mine - ref| of one leaf as a float32 scalar, NaN equal
    to NaN and a NaN against a number infinite."""
    if not (mine.is_floating_point() or mine.is_complex()):
        return (mine != ref).any().to(torch.float32)
    a, b = mine.to(torch.float64), ref.to(torch.float64)
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, torch.zeros_like(a),
                    torch.where(na | nb, torch.full_like(a, float("inf")),
                                (a - b).abs()))
    if d.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=d.device)
    # inf - inf is NaN: equal infinities are equal
    d = torch.where(a == b, torch.zeros_like(d), d)
    return d.max().to(torch.float32)


def check_replica_consistency(tree, atol: float = 0.0, label: str = "state",
                              group=None, mesh=None) -> None:
    """Assert that a replicated tree (a train state, a module) holds the
    same values on every rank: rank 0's copy is broadcast, each rank takes
    the largest difference of every leaf (NaN equal to NaN), and an
    all-reduce MAX of those finds the leaves that differ anywhere.  Raises
    ``AssertionError`` naming the first such leaf on every rank.  Python
    scalars and generator states are compared exactly.  One process:
    nothing to compare.

    ``mesh`` (a ``pgx_torch.parallel.tp.Mesh2D`` whose model axis shards
    the train state ``tree``): the blocks are compared within each data
    group (the ranks that hold the same block), then the gathered whole
    state over the world; every rank calls it."""
    if mesh is not None and mesh.n_model > 1:
        from pgx_torch.parallel.tp import gather_state
        check_replica_consistency(tree, atol, f"{label} (blocks)",
                                  mesh.data_group)
        check_replica_consistency(gather_state(mesh, tree), atol, label,
                                  mesh.world_group)
        return
    if world_size(group) == 1:
        return
    leaves = list(named_state_leaves(tree))
    tensors = [(n, v.detach()) for n, v in leaves
               if isinstance(v, torch.Tensor)]
    tensors += [(n, g.get_state()) for n, g in leaves
                if isinstance(g, torch.Generator)]
    wire = _wire_device(group, leaves)
    diffs = torch.zeros(len(tensors), dtype=torch.float32, device=wire)
    if tensors:
        flat = torch.cat([_bytes_of(v, wire) for _, v in tensors])
        dist.broadcast(flat, src=first_rank(group), group=group)
        lo = 0
        for i, (_, v) in enumerate(tensors):
            n = v.numel() * v.element_size()
            ref = flat[lo:lo + n].clone().view(v.dtype).view(v.shape)
            diffs[i] = _leaf_diff(v.to(wire), ref)
            lo += n
        dist.all_reduce(diffs, op=dist.ReduceOp.MAX, group=group)
    for (name, _), d in zip(tensors, diffs.tolist()):
        if not d <= atol:
            raise AssertionError(
                f"{label}.{name} differs between rank 0 and another rank "
                f"(largest difference {d})")
    scalars = [(n, v) for n, v in leaves
               if isinstance(v, (bool, int, float))]
    ref = broadcast_obj(scalars, group)
    same = torch.tensor([float(ref != scalars)], device=wire)
    dist.all_reduce(same, op=dist.ReduceOp.MAX, group=group)
    if same.item():
        raise AssertionError(f"{label}: the Python scalars differ between "
                             f"ranks (rank {rank(group)}: {scalars}, rank "
                             f"0: {ref})")
