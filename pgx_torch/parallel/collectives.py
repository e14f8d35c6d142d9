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

Spatial model parallelism (``tp``'s ``spatial`` mode: every rank of a model
group holds rows ``[m * h, (m + 1) * h)`` of every image) adds the row
collectives over the model group, each an autograd Function that is
differentiable to any order in both modes, as ``all_reduce_sum`` is:

* ``halo_exchange`` gives each rank ``rows`` rows of each neighbour on the
  model axis above and below its own, filled at the true image edges by the
  caller's rule (``'zero'``: SAME padding; ``'edge'``: the edge row
  repeated, bilinear resampling's clamp; ``'none'``: no rows).  Its
  backward adds each halo row's gradient into the neighbour's edge row it
  came from (``_HaloReturn``, whose own backward is the exchange again).
* ``gather_rows`` joins the ranks' rows into whole images on every rank;
  its backward is the reduce-scatter (``_ReduceScatterRows``: the sum of
  every rank's gradient of the whole image, this rank's rows), whose own
  backward is the gather.
* ``split_rows``, the gather's inverse, takes this rank's rows of a whole
  image back: a local slice, whose backward pads with zeros.

They share one convention: a tensor every rank of the group computes alike
(a whole image after ``gather_rows``, a loss) carries on each rank that
rank's part of its gradient, the parts summing to the gradient, and a
tensor each rank holds its own part of (rows) carries its whole gradient.
Every collective's backward is its exact adjoint under it, so a scalar
every rank computes alike, differentiated on every rank, yields
``n_model`` times its gradient summed over the group: the train step
divides an input gradient taken that way by ``n_model`` and averages the
parameters' gradients over the world.

Each moves data in two forms that compute the same numbers: on NCCL the
halo through ``batch_isend_irecv`` with the two neighbours alone and the
rows through ``all_gather_into_tensor`` / ``reduce_scatter_tensor``; on
gloo through ``all_reduce`` alone (zero-filled buffers with this rank's
part written in).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "average_", "world_size", "rank", "active",
           "first_rank", "gather_model_axis", "reduce_to_shards",
           "halo_exchange", "gather_rows", "split_rows"]


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


# ---------------------------------------------------------------------------
# Spatial model parallelism: the row collectives over the model group
# ---------------------------------------------------------------------------

HALO_FILLS = ("zero", "edge", "none")


def _exchange(mesh, up: Optional[torch.Tensor], down: Optional[torch.Tensor],
              like: torch.Tensor):
    """Each rank sends ``up`` to the rank above it on the model axis (m - 1)
    and ``down`` to the one below (m + 1); returns ``(from_up, from_down)``,
    what m - 1 sent down and m + 1 sent up (None at the true edges, where
    ``up`` resp. ``down`` is None too).  Every tensor has ``like``'s shape
    and dtype."""
    if _nccl(mesh.model_group):
        return _exchange_p2p(mesh, up, down, like)
    return _exchange_gloo(mesh, up, down, like)


def _exchange_p2p(mesh, up, down, like):
    """``_exchange`` through ``batch_isend_irecv`` with the neighbours."""
    peers = dist.get_process_group_ranks(mesh.model_group)
    ops, from_up, from_down = [], None, None
    if up is not None:
        from_up = torch.empty_like(like, memory_format=torch.contiguous_format)
        peer = peers[mesh.m - 1]
        ops += [dist.P2POp(dist.isend, up.contiguous(), peer,
                           mesh.model_group),
                dist.P2POp(dist.irecv, from_up, peer, mesh.model_group)]
    if down is not None:
        from_down = torch.empty_like(like,
                                     memory_format=torch.contiguous_format)
        peer = peers[mesh.m + 1]
        ops += [dist.P2POp(dist.isend, down.contiguous(), peer,
                           mesh.model_group),
                dist.P2POp(dist.irecv, from_down, peer, mesh.model_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_up, from_down


def _exchange_gloo(mesh, up, down, like):
    """``_exchange`` through ``all_reduce`` alone: an ``(n_model, 2, ...)``
    zero buffer with this rank's two parts written in."""
    n, m = mesh.n_model, mesh.m
    buf = torch.zeros((n, 2) + tuple(like.shape), dtype=like.dtype,
                      device=like.device)
    if up is not None:
        buf[m, 0].copy_(up)
    if down is not None:
        buf[m, 1].copy_(down)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return (buf[m - 1, 1] if up is not None else None,
            buf[m + 1, 0] if down is not None else None)


def _halo_rows(mesh, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` (this rank's rows on dim 1) with ``rows`` rows of the rank
    above before it and of the rank below after it (none at the true
    edges)."""
    if x.shape[1] < rows:
        raise ValueError(f"a halo of {rows} rows needs at least {rows} rows "
                         f"a rank, got {x.shape[1]}")
    n, m = mesh.n_model, mesh.m
    first, last = x[:, :rows], x[:, x.shape[1] - rows:]
    from_up, from_down = _exchange(mesh, first if m > 0 else None,
                                   last if m < n - 1 else None, first)
    return torch.cat([t for t in (from_up, x, from_down) if t is not None],
                     dim=1)


def _halo_return(mesh, g: torch.Tensor, rows: int) -> torch.Tensor:
    """The adjoint of ``_halo_rows``: the middle rows of ``g`` with the
    gradient of each neighbour's halo added into the edge rows it was
    taken from."""
    n, m = mesh.n_model, mesh.m
    top = rows if m > 0 else 0
    bot = rows if m < n - 1 else 0
    h = g.shape[1] - top - bot
    gx = g[:, top:top + h].clone(memory_format=torch.contiguous_format)
    from_up, from_down = _exchange(mesh, g[:, :top] if top else None,
                                   g[:, top + h:] if bot else None,
                                   gx[:, :rows])
    if from_up is not None:
        gx[:, :rows] += from_up
    if from_down is not None:
        gx[:, h - rows:] += from_down
    return gx


class _HaloExchange(torch.autograd.Function):
    """``_halo_rows``; backward ``_HaloReturn``, jvp itself."""

    @staticmethod
    def forward(ctx, x, mesh, rows):
        ctx.mesh, ctx.rows = mesh, rows
        return _halo_rows(mesh, x, rows)

    @staticmethod
    def backward(ctx, g):
        return _HaloReturn.apply(g, ctx.mesh, ctx.rows), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _rows_t):
        return _HaloExchange.apply(x_t, ctx.mesh, ctx.rows)


class _HaloReturn(torch.autograd.Function):
    """``_halo_return``; backward ``_HaloExchange``, jvp itself."""

    @staticmethod
    def forward(ctx, g, mesh, rows):
        ctx.mesh, ctx.rows = mesh, rows
        return _halo_return(mesh, g, rows)

    @staticmethod
    def backward(ctx, gg):
        return _HaloExchange.apply(gg, ctx.mesh, ctx.rows), None, None

    @staticmethod
    def jvp(ctx, g_t, _mesh_t, _rows_t):
        return _HaloReturn.apply(g_t, ctx.mesh, ctx.rows)


def halo_exchange(x: torch.Tensor, mesh, rows: int = 1,
                  fill: str = "zero") -> torch.Tensor:
    """``x``, this rank's rows of NHWC images split over H across
    ``mesh``'s model group, with ``rows`` halo rows above and below: the
    neighbours' edge rows inside the image, and at the true image edges
    ``fill``'s rows (``'zero'``: zeros, a SAME conv's padding; ``'edge'``:
    the edge row repeated, the clamp of ``align_corners=False`` bilinear
    resampling; ``'none'``: nothing, so an edge rank's result has ``rows``
    fewer rows on that side).  Differentiable to any order in both modes
    (module docstring).  Every rank of the model group calls it with
    tensors of the same shape, in the same order.  At ``n_model == 1`` only
    the fill."""
    if fill not in HALO_FILLS:
        raise ValueError(f"fill must be one of {HALO_FILLS}, got {fill!r}")
    n, m = mesh.n_model, mesh.m
    y = _HaloExchange.apply(x, mesh, rows) if n > 1 else x
    if fill == "none":
        return y
    if fill == "zero":
        pad = lambda edge: torch.zeros_like(edge)
    else:
        pad = lambda edge: edge.expand(-1, rows, *edge.shape[2:])
    parts = [y]
    if m == 0:
        parts.insert(0, pad(x[:, :1] if fill == "edge" else x[:, :rows]))
    if m == n - 1:
        parts.append(pad(x[:, -1:] if fill == "edge" else x[:, -rows:]))
    return torch.cat(parts, dim=1)


def _gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' rows (dim 1) joined in model-axis order, on every rank."""
    n = mesh.n_model
    if _nccl(mesh.model_group):
        flat = x.contiguous().view(-1)
        buf = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, flat, group=mesh.model_group)
        buf = buf.view(n, *x.shape)
    else:
        buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[mesh.m].copy_(x)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.model_group)
    b, h = x.shape[0], x.shape[1]
    return buf.transpose(0, 1).reshape(b, n * h, *x.shape[2:])


def _reduce_scatter_rows(mesh, y: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``_gather_rows``: ``y`` (whole on dim 1) summed over
    the ranks, this rank's rows."""
    n, m = mesh.n_model, mesh.m
    if y.shape[1] % n:
        raise ValueError(f"{y.shape[1]} rows do not split over {n} ranks")
    h = y.shape[1] // n
    if _nccl(mesh.model_group):
        parts = y.reshape(y.shape[0], n, h, *y.shape[2:]).transpose(0, 1)
        parts = parts.contiguous()
        mine = torch.empty(parts[0].numel(), dtype=y.dtype, device=y.device)
        dist.reduce_scatter_tensor(mine, parts.view(-1),
                                   op=dist.ReduceOp.SUM,
                                   group=mesh.model_group)
        return mine.view(parts.shape[1:])
    out = y.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return out[:, m * h:(m + 1) * h].contiguous()


class _GatherRows(torch.autograd.Function):
    """``_gather_rows``; backward ``_ReduceScatterRows``, jvp itself."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterRows.apply(g, ctx.mesh), None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t):
        return _GatherRows.apply(x_t, ctx.mesh)


class _ReduceScatterRows(torch.autograd.Function):
    """``_reduce_scatter_rows``; backward ``_GatherRows``, jvp itself."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return _reduce_scatter_rows(mesh, y)

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.mesh), None

    @staticmethod
    def jvp(ctx, y_t, _mesh_t):
        return _ReduceScatterRows.apply(y_t, ctx.mesh)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Whole images on every rank of ``mesh``'s model group from each
    rank's rows (dim 1, rank m's block m), differentiable to any order in
    both modes; its backward is the reduce-scatter (module docstring).  At
    ``n_model == 1`` ``x`` itself."""
    if mesh.n_model == 1:
        return x
    return _GatherRows.apply(x, mesh)


def split_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (dim 1, block ``mesh.m`` of ``mesh.n_model``) of
    whole images: the inverse of ``gather_rows``, a local slice, copied
    contiguous (its backward pads with zeros: module docstring)."""
    n = mesh.n_model
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} rows do not split over {n} ranks")
    if n == 1:
        return x
    h = x.shape[1] // n
    return x[:, mesh.m * h:(mesh.m + 1) * h].contiguous()
