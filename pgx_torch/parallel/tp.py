"""Model-axis parallelism (counterpart of ``pgx/parallel/tp.py``): a 2-D
``(data, model)`` grid of ranks, in one of pgx's two modes: the train state
channel-sharded over the model axis (``channels``), or the images split
over H across it (``spatial``).

``pgx`` places the state and the images with ``NamedSharding`` and lets
GSPMD partition the unchanged step.  The port runs one process per rank
and chooses the partition itself.

* **The grid.** ``n_data * n_model`` ranks, the model axis minor: rank
  ``d * n_model + m`` is grid position ``(d, m)``; the model groups are
  consecutive ranks, the data groups the ranks with the same ``m``.
  ``Mesh2D.mode`` names the mode; ``make_train_step(..., mesh=)`` and the
  loop read it.

``channels`` mode: **the parameters are gathered, not the activations**.

* **The state at rest**: every floating leaf whose trailing dim divides
  ``n_model`` keeps only block ``m`` of that dim on rank ``(d, m)``
  (``_leaf_spec``, pgx's rule): conv HWIO kernels and biases on C_out, the
  HWOI input projection on its latent dim, linears on their output dim,
  the embedding table on its dim, for G, D, G_ema and both Adam moments.
  The 3-channel to_rgb heads, scalars, counters and the random generator
  stay whole on every rank.
* **The step**: every rank takes its own rows of the global batch, ``batch
  / (n_data * n_model)``, so no arithmetic repeats across the model axis.
  It gathers G's and D's parameters whole over the model group at the top
  (outside autograd, as ``weights_cast='once'`` makes its copy), runs pgx's
  step on them, averages each gradient over the world and keeps its block
  (``pgx_torch.parallel.collectives.reduce_to_shards``), and runs Adam and
  the EMA on the blocks; D is gathered again after its update for the G
  step.  The whole parameters are released at the end of the step.
* **Host reads** (checkpoints, sample grids, FID): ``gather_state``, a
  collective every rank enters; the result is the whole state, so a
  checkpoint is the same files at any ``n_model``.

What the channels mode saves is the **state's bytes at rest**: the
activations are not split (each rank holds its rows, as at world ``n_data
* n_model`` of pure data parallelism), and kernels A, B and C
pixel-normalise over every channel of a row, which a split C_out would
make a cross-rank statistic.

``spatial`` mode: **the activations are split, the state is not**.

* **Placement** (``spatial_batch_sharding``, pgx's ``P('data',
  'model')``): rank ``(d, m)`` holds the rows of data position ``d``
  (``batch / n_data``) and rows ``[m * H / n, (m + 1) * H / n)`` of every
  image; the model ranks of one data position share their batch rows.
  The state is whole on every rank (``shard_state`` and ``gather_state``
  leave it as it is), so host reads need no collective.
* **The models** (``rows=mesh``): every padding-1 3x3 conv runs on its
  rows with a halo of one row from each neighbour (zeros at the true
  edges: SAME padding; kernel C on the haloed tile, its halo rows cropped
  after), ``upsample2x`` with a halo that repeats the edge row at the true
  edges, ``downsample2x`` locally (H / n even); G starts split at the first
  resolution ``n_model`` divides (the 4x4 input for ``n_model <= 4``); D
  gathers its rows whole before the minibatch statistic and the 4x4 head,
  or earlier where a rank holds one row and the 2x2 pool would cross the
  cut.  The ADA pipe warps whole images: gather, pipe, split.
* **The step**: z, eps and the draws are sliced by ``d`` over ``n_data``;
  the penalty's norms are summed over the model group; the gradients are
  averaged over the world, every rank's loss counting once per model rank
  (``collectives``' convention), and the penalty's input gradient divides
  the model ranks' ``n_model`` copies out.
* **Stages shorter than the axis** (``use_spatial_sharding`` says no: 4px
  at ``n_model = 8``) fall back to batch-only placement, as pgx's do: each
  rank its own rows of the world, the state still whole.
"""

from __future__ import annotations

import copy
import dataclasses
import socket
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pgx_torch.parallel.collectives import (gather_model_axis, rank,
                                            reduce_to_shards, world_size)
from pgx_torch.parallel.distributed import named_state_leaves

DATA_AXIS = "data"
MODEL_AXIS = "model"
MODES = ("channels", "spatial")

_MODULES = ("g", "d", "g_ema")
_OPTS = {"opt_g": "g", "opt_d": "d"}
# a sharded module -> the names of its sharded parameters
_LAYOUTS: "weakref.WeakKeyDictionary[torch.nn.Module, frozenset]" = \
    weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``(data, model)`` grid of ``n_data * n_model`` ranks, this rank at
    ``(d, m)``; ``world_group`` holds every rank, ``model_group`` this
    rank's row (the ranks ``d * n_model + [0, n_model)``), ``data_group``
    its column (the ranks with the same ``m``).  The groups are None at
    world 1.  ``mode``: ``'channels'`` (the state sharded over the model
    axis) or ``'spatial'`` (the images split over H across it)."""

    n_data: int
    n_model: int
    d: int = 0
    m: int = 0
    world_group: Any = None
    model_group: Any = None
    data_group: Any = None
    mode: str = "channels"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown model_parallel_mode {self.mode!r} "
                             f"(channels|spatial)")

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.d * self.n_model + self.m


def make_mesh_2d(n_data: int, n_model: int, group=None,
                 mode: str = "channels") -> Mesh2D:
    """The ``(data, model)`` grid over the ranks of ``group`` (the default
    group when None; no group at world 1), model axis minor, in ``mode``.

    Raises pgx's ``ValueError`` when the world has fewer than ``n_data *
    n_model`` ranks, and when the model axis would span hosts: the ranks
    name their hosts to each other (a collective), and ``n_model`` must
    divide every host's count of ranks and each model group must lie on
    one host.  Every rank of a multi-process run must be on the grid.
    Every rank creates every subgroup, in the same order."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes must be >= 1")
    Mesh2D(n_data, n_model, mode=mode)          # refuses an unknown mode
    world = world_size(group)
    need = n_data * n_model
    if world < need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"have {world}")
    if world > 1:
        _refuse_model_axis_across_hosts(n_data, n_model, group)
    if world != need:
        raise ValueError(f"mesh {n_data}x{n_model} covers {need} of the "
                         f"{world} processes; a multi-process run cannot "
                         f"leave a process off the mesh")
    if world == 1:
        return Mesh2D(1, 1, mode=mode)
    me = rank(group)
    ranks = (list(range(world)) if group is None or group is dist.group.WORLD
             else dist.get_process_group_ranks(group))
    model_group = data_group = None
    for dd in range(n_data):
        g = dist.new_group([ranks[dd * n_model + mm]
                            for mm in range(n_model)])
        if dd == me // n_model:
            model_group = g
    for mm in range(n_model):
        g = dist.new_group([ranks[dd * n_model + mm]
                            for dd in range(n_data)])
        if mm == me % n_model:
            data_group = g
    return Mesh2D(n_data, n_model, me // n_model, me % n_model,
                  group if group is not None else dist.group.WORLD,
                  model_group, data_group, mode)


def _refuse_model_axis_across_hosts(n_data: int, n_model: int,
                                    group) -> None:
    """pgx's refusal of a model axis that spans hosts, read from the hosts
    the ranks of ``group`` run on (``socket.gethostname``, gathered): every
    rank reads every host's count, so every rank raises alike."""
    hosts: List[Optional[str]] = [None] * world_size(group)
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    for host in dict.fromkeys(hosts):
        local = hosts.count(host)
        if local % n_model:
            raise ValueError(
                f"model_parallel={n_model} does not divide the {local} "
                f"local devices per host; the model axis must not span "
                f"hosts")
    for dd in range(n_data):
        row = hosts[dd * n_model:(dd + 1) * n_model]
        if len(set(row)) > 1:
            raise ValueError(
                f"model group {dd} (ranks {dd * n_model}-"
                f"{(dd + 1) * n_model - 1}) runs on the hosts {row}; the "
                f"model axis must not span hosts")


def make_mesh_2d_for_batch(batch_size: int, n_model: int, group=None,
                           mode: str = "channels") -> Mesh2D:
    """The grid of every rank of ``group`` with ``n_model`` on the model
    axis, in ``mode``.  Raises pgx's ``ValueError`` when ``n_model`` does
    not divide the world.  Departure from pgx: every rank takes
    ``batch_size / world`` rows (in spatial mode at the stages that fall
    back to batch-only placement), so the world must divide the batch
    (``ValueError`` otherwise).
    pgx shrinks the data axis to a divisor of the batch inside one process
    and refuses to across hosts; the port's ranks are processes, none of
    which can be dropped, so it always refuses."""
    world = world_size(group)
    if world % n_model:
        raise ValueError(f"model_parallel={n_model} does not divide the "
                         f"{world} available devices")
    if batch_size % world:
        raise ValueError(
            f"batch_size={batch_size} is not divisible by the {world} "
            f"ranks of the {world // n_model}x{n_model} mesh (every rank "
            f"takes its own rows); a multi-host run cannot drop devices — "
            f"raise batch_size to a multiple of {world}")
    return make_mesh_2d(world // n_model, n_model, group, mode)


def _leaf_spec(leaf, n_model: int) -> Tuple:
    """pgx's channel-sharding rule for one leaf, as a ``PartitionSpec``'s
    entries: ``(None, ..., 'model')`` (sharded on the trailing dim) for a
    floating tensor of at least one dim whose trailing dim ``n_model``
    divides, ``()`` (replicated) for anything else."""
    if (not isinstance(leaf, torch.Tensor) or leaf.dim() == 0
            or not leaf.is_floating_point() or leaf.shape[-1] % n_model):
        return ()
    return (None,) * (leaf.dim() - 1) + (MODEL_AXIS,)


def sharded_names(module: torch.nn.Module) -> frozenset:
    """The names of ``module``'s parameters that hold one block (empty for
    a module ``shard_state`` has not sharded)."""
    return _LAYOUTS.get(module, frozenset())


def _opt_net(state, key: str) -> torch.nn.Module:
    net = state.get(_OPTS[key])
    if not isinstance(net, torch.nn.Module):
        raise ValueError(f"{key} needs its module {_OPTS[key]!r} in the "
                         f"same state")
    return net


def state_shardings(state, mesh: Mesh2D) -> Dict[str, Tuple]:
    """Per leaf of a train state (or any tree of modules and tensors), by
    the port's leaf name (pgx's, joined by '.'): ``()`` replicated, or
    ``(None, ..., 'model')`` sharded on the trailing dim over the model
    axis.  The rule is read from the whole leaves, or for a state
    ``shard_state`` has sharded, from its recorded layout."""
    n = mesh.n_model
    out = {}
    for name, leaf in named_state_leaves(state):
        top, _, rest = name.partition(".")
        layout = None
        if isinstance(state, dict) and top in _MODULES and \
                isinstance(state[top], torch.nn.Module):
            layout = _LAYOUTS.get(state[top])
            key = rest
        elif isinstance(state, dict) and top in _OPTS:
            layout = _LAYOUTS.get(state.get(_OPTS[top]))
            key = rest.partition(".")[2]
        if layout is not None:
            out[name] = ((None,) * (leaf.dim() - 1) + (MODEL_AXIS,)
                         if key in layout else ())
        else:
            out[name] = _leaf_spec(leaf, n)
    return out


def _block(t: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Block ``m`` of ``n`` along the last dim, as a tensor of its own."""
    k = t.shape[-1] // n
    return t[..., m * k:(m + 1) * k].clone()


@torch.no_grad()
def shard_state(mesh: Mesh2D, state):
    """Keep only this rank's block of every sharded leaf (the rule of
    ``state_shardings``), in place: each module's sharded parameters are
    re-pointed at their block, each Adam moment replaced by its block, the
    whole tensors freed.  Every rank must hold the same whole state
    (``broadcast_state``).  Returns ``state``; at ``n_model == 1`` and in
    spatial mode (the state is whole on every rank) unchanged."""
    n, m = mesh.n_model, mesh.m
    if n == 1 or mesh.mode == "spatial":
        return state
    for key in _MODULES:
        module = state.get(key)
        if not isinstance(module, torch.nn.Module):
            continue
        if module in _LAYOUTS:
            raise ValueError(f"state[{key!r}] is already sharded")
        names = []
        for name, p in module.named_parameters():
            if _leaf_spec(p, n):
                p.data = _block(p.data, n, m)
                names.append(name)
        _LAYOUTS[module] = frozenset(names)
    for key in _OPTS:
        if key not in state:
            continue
        layout = _LAYOUTS[_opt_net(state, key)]
        for moment in ("mu", "nu"):
            state[key][moment] = {
                name: _block(t, n, m) if name in layout else t
                for name, t in state[key][moment].items()}
    return state


def _sharded_leaves(state) -> List[Tuple[str, str, Optional[str]]]:
    """``(key, name, moment)`` of every sharded leaf of a sharded state, in
    a fixed order (the same on every rank)."""
    out = []
    for key in _MODULES:
        module = state.get(key)
        if isinstance(module, torch.nn.Module):
            for name, _ in module.named_parameters():
                if name in sharded_names(module):
                    out.append((key, name, None))
    for key in _OPTS:
        if key in state:
            layout = sharded_names(_opt_net(state, key))
            for moment in ("mu", "nu"):
                out.extend((key, name, moment) for name in state[key][moment]
                           if name in layout)
    return out


@torch.no_grad()
def gather_state(mesh: Mesh2D, state):
    """The whole state from a sharded one (what ``jax.device_get`` returns
    for pgx's sharded state): a new state whose modules and Adam moments
    are copies, every tensor whole; the sharded state is left as it is.
    A collective: every rank of the model group enters it (the loop: every
    rank, at the same iteration).  Keys other than ``g``, ``d``,
    ``g_ema``, ``opt_g`` and ``opt_d`` are shared, not copied.  At
    ``n_model == 1`` and in spatial mode (nothing is sharded) the state
    itself."""
    if mesh.n_model == 1 or mesh.mode == "spatial":
        return state
    leaves = _sharded_leaves(state)
    shards = []
    for key, name, moment in leaves:
        shards.append(state[key].get_parameter(name) if moment is None
                      else state[key][moment][name])
    whole = gather_model_axis(mesh, shards)
    out = dict(state)
    for key in _MODULES:
        if isinstance(state.get(key), torch.nn.Module):
            out[key] = copy.deepcopy(state[key])
    for key in _OPTS:
        if key in state:
            layout = sharded_names(_opt_net(state, key))
            out[key] = dict(state[key], **{
                moment: {n: t if n in layout else t.clone()
                         for n, t in state[key][moment].items()}
                for moment in ("mu", "nu")})
    for (key, name, moment), t in zip(leaves, whole):
        if moment is None:
            out[key].get_parameter(name).data = t
        else:
            out[key][moment][name] = t
    return out


def gather_module(mesh: Mesh2D, module: torch.nn.Module) -> torch.nn.Module:
    """A whole copy of one sharded module (``gather_state`` of it alone);
    the module itself when it is not sharded."""
    if not sharded_names(module):
        return module
    return gather_state(mesh, {"g": module})["g"]


@torch.no_grad()
def unshard_(mesh: Mesh2D, modules: Sequence[torch.nn.Module],
             shards: Optional[Sequence[Dict[str, torch.Tensor]]] = None
             ) -> List[Dict[str, torch.Tensor]]:
    """Make every sharded parameter of ``modules`` whole in place, through
    one gather: the step's parameters.  Returns, per module, its blocks by
    name (what ``reshard_`` points the module back at; the master weights
    the optimizer updates).  ``shards``: the blocks of an earlier call, to
    gather again after they changed (the module is whole then)."""
    if shards is None:
        shards = [{name: p.data for name, p in mod.named_parameters()
                   if name in sharded_names(mod)} for mod in modules]
    flat = [t for s in shards for t in s.values()]
    whole = iter(gather_model_axis(mesh, flat))
    for mod, s in zip(modules, shards):
        for name in s:
            mod.get_parameter(name).data = next(whole)
    return list(shards)


def reshard_(module: torch.nn.Module, shards: Dict[str, torch.Tensor]) -> None:
    """Point ``module``'s sharded parameters back at their blocks: the
    whole tensors are freed (the state at rest)."""
    for name, t in shards.items():
        module.get_parameter(name).data = t


def reduce_gradients(mesh: Mesh2D, modules: Sequence[torch.nn.Module],
                     grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``grads`` (the whole gradients of the modules' parameters, in
    ``named_parameters`` order, module after module) averaged over the
    world, each sharded parameter's cut to this rank's block (``grads``
    may be averaged in place)."""
    flags = [name in sharded_names(mod) for mod in modules
             for name, _ in mod.named_parameters()]
    if len(flags) != len(grads):
        raise ValueError(f"{len(grads)} gradients for {len(flags)} "
                         f"parameters")
    return reduce_to_shards(mesh, grads, flags)


def resident_bytes(state) -> int:
    """The bytes of every tensor leaf of a train state (its modules'
    parameters, the Adam moments, the controller): what a rank holds at
    rest."""
    return sum(t.numel() * t.element_size()
               for _, t in named_state_leaves(state)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """One rank's part of a batch of NHWC images under pgx's ``P('data',
    'model')``: the rows of data position ``d`` (block ``d`` of ``n_data``
    on the batch dim) and block ``m`` of ``n_model`` on H; W and C whole."""

    n_data: int
    n_model: int
    d: int
    m: int

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        if batch % self.n_data:
            raise ValueError(f"batch {batch} does not split over "
                             f"{self.n_data} data positions")
        b = batch // self.n_data
        return slice(self.d * b, (self.d + 1) * b)

    def height_rows(self, height: int) -> slice:
        """This rank's rows of an image ``height`` rows high."""
        if height % self.n_model:
            raise ValueError(f"height {height} does not split over "
                             f"{self.n_model} model ranks")
        h = height // self.n_model
        return slice(self.m * h, (self.m + 1) * h)

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's index into a global NHWC array of ``shape`` (what
        pgx's ``devices_indices_map`` gives the device at ``(d, m)``)."""
        return (self.batch_rows(shape[0]), self.height_rows(shape[1]),
                slice(None), slice(None))

    def __call__(self, x):
        """This rank's part of a global batch ``x`` (an array or tensor)."""
        return x[self.index(x.shape)]


def spatial_batch_sharding(mesh: Mesh2D) -> SpatialSharding:
    """``spatial`` mode's image placement for this rank of ``mesh`` (batch
    over ``data``, H over ``model``)."""
    return SpatialSharding(mesh.n_data, mesh.n_model, mesh.d, mesh.m)


def use_spatial_sharding(resolution: int, n_model: int) -> bool:
    """Spatial mode's per-stage gate: early growth stages can be SHORTER
    than the model axis (4px with --model-parallel 8), where splitting H
    n_model-ways is impossible — those stages fall back to batch-only
    sharding.  Powers of two make divisibility the whole condition."""
    return resolution % n_model == 0


def spatial_active(mesh: Optional[Mesh2D], resolution: int) -> bool:
    """Whether a stage at ``resolution`` splits its images over ``mesh``'s
    model axis: spatial mode, a model axis, and ``use_spatial_sharding``
    (otherwise the stage takes batch-only placement)."""
    return (mesh is not None and mesh.mode == "spatial" and mesh.n_model > 1
            and use_spatial_sharding(resolution, mesh.n_model))
