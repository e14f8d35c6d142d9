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

Only ``all_reduce``, ``broadcast`` and ``barrier`` touch card tensors:
those are what the gloo backend accepts for CUDA tensors as well as NCCL.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "average_", "world_size", "rank", "active"]


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
