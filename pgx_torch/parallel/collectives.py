"""The collectives that GSPMD inserts implicitly in ``pgx``.

Under ``jit`` with the batch sharded over a ``('data',)`` mesh, every batch
reduction of ``pgx``'s train step (the losses, the gradients, the
minibatch-stddev, the ADA controller's sign sum) is global without a line
of collective code.  The port runs one process per rank, each holding its
rows of the batch; the reductions that must see the whole batch go through
``all_reduce_sum`` here, and the optimizer's gradients through
``average_``.

``all_reduce_sum`` is an autograd Function that is differentiable to any
order in both modes: its backward all-reduces the incoming gradient through
the same Function (so a double backward, the reverse gradient penalty,
sees the collective again), and its ``jvp`` all-reduces the tangent (the
jvp penalty's dual forward, whose tangent is then differentiated in
reverse).  ``torch.distributed.nn.functional.all_reduce`` has the same
backward but no ``jvp``.

Only ``all_reduce``, ``broadcast`` and ``barrier`` touch card tensors
under gloo: those are what the gloo backend accepts for CUDA tensors.

Channel-sharded model parallelism (``pgx_torch.parallel.tp``) adds the two
collectives of its step, each in two forms that compute the same numbers:
``gather_model_axis`` joins each tensor's blocks along the last dim over the
model group, and ``reduce_to_shards`` averages gradients over the world and
keeps this rank's block of each sharded one.  On NCCL they move the
fewest bytes (``all_gather_into_tensor``; ``reduce_scatter_tensor`` over the
model group and an ``all_reduce`` over the data group); on gloo they use
``all_reduce`` alone (a zero-filled whole buffer with this rank's block
written in; ``average_``, then the slice).  The group's backend picks; both
forms compute the same numbers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "average_", "world_size", "rank", "active",
           "first_rank", "gather_model_axis", "reduce_to_shards"]


def active(group=None) -> bool:
    """True when a process group is initialized and has more than one
    rank; ``group=None`` reads the default group."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)


def world_size(group=None) -> int:
    """Ranks in ``group`` (1 without an initialized process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def first_rank(group=None) -> int:
    """The global rank of ``group``'s rank 0 (the source a broadcast over
    the group names)."""
    if group is None or group is dist.group.WORLD:
        return 0
    return dist.get_global_rank(group, 0)


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``, on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # d(sum_r x_r)/dx_q is the identity for every q: rank q's gradient
        # is the sum of every rank's incoming gradient
        return _AllReduceSum.apply(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, x_t: torch.Tensor, _group_t) -> torch.Tensor:
        return _AllReduceSum.apply(x_t, ctx.group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group when
    None), differentiable to any order in reverse and forward mode.  Every
    rank must call it in the same order, in the forward and, when a
    gradient is taken, in the backward."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def average_(tensors: List[torch.Tensor], group=None,
             world: Optional[int] = None) -> None:
    """Replace each tensor by its mean over the ranks, in place, through
    one all-reduce of the flattened tensors (SUM, then divided by the world
    size): the gradient averaging that ``pgx`` gets from GSPMD."""
    if not tensors:
        return
    n = world_size(group) if world is None else world
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(n)
    lo = 0
    for t in tensors:
        t.copy_(flat[lo:lo + t.numel()].view_as(t))
        lo += t.numel()


def _nccl(group) -> bool:
    """True when ``group`` runs on NCCL (the forms that move the fewest
    bytes); gloo takes ``all_reduce`` alone for card tensors."""
    return dist.get_backend(group) == "nccl"


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """The tensors' indices grouped by dtype, in order (one flat buffer and
    one collective per dtype)."""
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


@torch.no_grad()
def gather_model_axis(mesh, shards: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Each tensor whole: the ``mesh.n_model`` blocks held by the ranks of
    ``mesh.model_group`` joined along the last dim, block j from the
    group's rank j (``[..., k]`` -> ``[..., n_model * k]``).  Every rank of
    the model group calls it with tensors of the same shapes and dtypes, in
    the same order.  Outside autograd; the values are copied exactly."""
    if mesh.n_model == 1:
        return [s.detach().clone() for s in shards]
    if _nccl(mesh.model_group):
        return _gather_nccl(mesh, shards)
    return _gather_gloo(mesh, shards)


def _gather_nccl(mesh, shards):
    """``gather_model_axis`` through ``all_gather_into_tensor``."""
    def fill(flat, n):
        buf = torch.empty(n * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        dist.all_gather_into_tensor(buf, flat, group=mesh.model_group)
        return buf.view(n, flat.numel())
    return _gather_with(mesh, shards, fill)


def _gather_gloo(mesh, shards):
    """``gather_model_axis`` through ``all_reduce`` alone: a zero-filled
    whole buffer with this rank's block written in (x + 0 == x exactly:
    the sum of one block and zeros is the block)."""
    def fill(flat, n):
        buf = torch.zeros(n, flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        buf[mesh.m].copy_(flat)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.model_group)
        return buf
    return _gather_with(mesh, shards, fill)


def _gather_with(mesh, shards, fill):
    """One ``fill(flat, n) -> (n, numel)`` per dtype over the flattened
    blocks, its rows cut back into whole tensors."""
    n = mesh.n_model
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for idx in _by_dtype(shards).values():
        buf = fill(torch.cat([shards[i].detach().reshape(-1) for i in idx]),
                   n)
        lo = 0
        for i in idx:
            s = shards[i]
            k, size = s.shape[-1], s.numel()
            blocks = buf[:, lo:lo + size].view(n, size // max(k, 1), k)
            out[i] = blocks.transpose(0, 1).reshape(*s.shape[:-1], n * k)
            lo += size
    return out


@torch.no_grad()
def reduce_to_shards(mesh, grads: Sequence[torch.Tensor],
                     sharded: Sequence[bool]) -> List[torch.Tensor]:
    """Gradients of each rank's local mean loss averaged over the world
    (summed over ``mesh.world_group``, divided by ``mesh.world``); for a
    tensor flagged in ``sharded`` (whole, ``[..., n_model * k]``) only this
    rank's block ``[..., m * k:(m + 1) * k]`` is returned, the others whole.
    Every rank calls it with the same shapes and flags, in the same
    order.  ``grads`` may be averaged in place (at ``n_model == 1`` this is
    ``average_``)."""
    if mesh.world == 1:      # n_model <= world: nothing is sharded
        return list(grads)
    if mesh.n_model > 1 and _nccl(mesh.model_group):
        return _reduce_nccl(mesh, grads, sharded)
    return _reduce_gloo(mesh, grads, sharded)


def _reduce_gloo(mesh, grads, sharded):
    """``reduce_to_shards`` as ``average_`` over the world (in place), then
    each sharded gradient's block."""
    n, m = mesh.n_model, mesh.m
    average_(list(grads), mesh.world_group, mesh.world)
    out = []
    for g, s in zip(grads, sharded):
        if s:
            k = g.shape[-1] // n
            g = g[..., m * k:(m + 1) * k].contiguous()
        out.append(g)
    return out


def _reduce_nccl(mesh, grads, sharded):
    """``reduce_to_shards`` through ``reduce_scatter_tensor`` over the
    model group and an ``all_reduce`` over the data group for the sharded
    gradients, ``average_`` over the world for the others."""
    world, n = mesh.world, mesh.n_model
    out: List[Optional[torch.Tensor]] = list(grads)
    average_([g for g, s in zip(grads, sharded) if not s], mesh.world_group,
             world)
    sh = [i for i in range(len(grads)) if sharded[i]]
    for idx in _by_dtype([grads[i] for i in sh]).values():
        idx = [sh[j] for j in idx]
        dtype = grads[idx[0]].dtype
        # block j of every tensor side by side in row j: the layout
        # reduce_scatter_tensor hands out by the group's ranks
        rows = torch.cat([
            grads[i].reshape(-1, n, grads[i].shape[-1] // n)
            .transpose(0, 1).reshape(n, -1) for i in idx], dim=1)
        mine = torch.empty(rows.shape[1], dtype=dtype, device=rows.device)
        dist.reduce_scatter_tensor(mine, rows.reshape(-1),
                                   op=dist.ReduceOp.SUM,
                                   group=mesh.model_group)
        if mesh.n_data > 1:
            dist.all_reduce(mine, op=dist.ReduceOp.SUM,
                            group=mesh.data_group)
        mine.div_(world)
        lo = 0
        for i in idx:
            g = grads[i]
            size = g.numel() // n
            out[i] = mine[lo:lo + size].view(*g.shape[:-1], g.shape[-1] // n)
            lo += size
    return out
