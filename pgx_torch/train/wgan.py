"""WGAN-GP training engine of the port: one stage-specialized train step,
and sampling from the (EMA) generator.

Counterpart of ``pgx/train/wgan.py``.  One iteration reproduces the
reference's math exactly:

  D loss   = -E[D(real)] + 0.001*E[D(real)^2]          (drift penalty)
             + E[D(fake)]
             + 10 * E[(||grad_{x_hat} D(x_hat)||_2 - 1)^2]   (WGAN-GP)
  with x_hat = eps*real + (1-eps)*fake, eps ~ U[0,1) per sample, the fake
  detached.
  G loss   = -E[D_updated(G(z))] with the SAME z as the D step and the
             freshly updated D.
  EMA      : g_ema = 0.999*g_ema + 0.001*g after every G update.
  Optimizers: two Adam(lr, betas=(0.0, 0.99), eps=1e-8), as optax computes
             them: one step count per optimizer, a parameter off the graph
             sees a zero gradient (its second moment decays, the shared
             count advances), eps outside the square root.

The gradient penalty's second-order term is, with ``gp_mode='reverse'``,
a double backward: ``torch.autograd.grad(sum(D(x_hat)), x_hat,
create_graph=True)`` and then the gradient of the loss.  The
discriminator's conv epilogues (kernel A) differentiate twice; the
generator's fused convs (kernel C) only once, and only the generator runs
them.  ``gp_mode='jvp'`` is pgx's exact surrogate: with ``g`` the input
gradient (taken with D's parameters frozen) and ``u = 2 lam (|g| - 1) g /
(|g| B)`` detached, the penalty's parameter gradient is that of the forward
derivative ``<u, grad_x D(x_hat)>``, a dual forward of D under
``torch.autograd.forward_ad`` differentiated in reverse mode (reverse over
forward: kernel A's tangent, backward and second-derivative kernels, and
first-order conv gradients).

``remat`` recomputes activations in the backward (non-reentrant
``torch.utils.checkpoint``): ``'full'`` around G's and D's forwards (under
jvp, around the dual forward as a whole), ``'d_only'`` around D's only.
``'convs'`` (keep what a conv produces, recompute the elementwise work)
adds no region: it is what the kernels' Functions already keep.  Kernel A
saves only its pre-bias conv output and bias and recomputes the epilogue
in its backward kernel; kernel C saves its conv output and the per-row
norm factor.
``weights_cast='once'`` runs each forward on one compute-dtype copy of the
parameters (``torch.func.functional_call``), made once per parameter state.

With ``augment_cfg`` the ADA pipeline (``pgx_torch.augment``) augments every
image D sees: the reals once, the D step's fake pass and the G step's fake
pass each with a fresh draw, ``x_hat`` built from the augmented endpoints.
The penalty's gradient is taken with respect to ``x_hat``, so the pipe sits
outside the double backward and needs a first-order gradient only (the G
step, and the joint pass of ``fused_g``).  With ``ada_cfg`` the adaptive
controller drives the probability from the detached real logits.

The random draws ``z`` and ``eps`` and the three augmentation draw sources
are inputs of the step: the caller makes them from an explicit
``torch.Generator`` (``draw_z_eps``, ``draw_augment_sources``), and a
parity test feeds the draws of another implementation.

The state holds ``nn.Module``s and is updated in place: the step returns the
same dict it was given.

With ``process_group`` the step is one rank's part of a data-parallel
step at the global batch, what ``pgx`` computes on a batch-sharded mesh:
each rank holds its rows of the batch; the minibatch-stddev statistic and
the ADA controller's sign sum are summed over the ranks
(``pgx_torch.parallel.collectives.all_reduce_sum``, differentiable to any
order, so the penalty's double backward and the jvp penalty's dual forward
see the other ranks' rows); each gradient is averaged over the ranks
before Adam (one all-reduce of the flattened gradients); the metrics are
the ranks' means.  The draws are the global batch's, the same on every
rank, and each rank keeps its rows.  ``DistributedDataParallel`` cannot
stand in: the step takes its gradients with ``torch.autograd.grad``, which
fires none of its hooks, and the penalty differentiates through the
collectives.

With ``mesh`` (a ``pgx_torch.parallel.tp.Mesh2D`` and a state
``shard_state`` has sharded over its model axis) the step is the same over
the world group, every rank of the grid taking its own rows, and the
parameters are gathered whole at the top of the step (outside autograd),
D again after its update; each gradient is averaged over the world and cut
to this rank's block; Adam and the EMA run on the blocks; the whole
parameters are released at the end (``pgx_torch.parallel.tp``).  A
``process_group`` is the ``(world, 1)`` grid of the same type, with nothing
sharded: one reduction, ``tp.reduce_gradients``, serves both.

With a ``mesh`` in spatial mode (``tp.Mesh2D.mode == 'spatial'``) the
state is whole on every rank and rank ``(d, m)`` holds rows ``[m * H / n,
(m + 1) * H / n)`` of the batch rows of data position ``d``; z, eps and the
augmentation draws are the global batch's, sliced by ``d`` over
``n_data``.  G and D run on the rows with halo exchanges (``rows=``), D
gathers whole images before its head, the ADA pipe warps whole images
(gather, pipe, split), the minibatch statistic and the controller's count
run over the data group, the penalty's squared norms are summed over the
model group.  Every model rank computes each loss alike, and the row
collectives' backwards are their exact adjoints
(``pgx_torch.parallel.collectives``), so each rank's gradient is its part
of ``n_model`` times the gradient: averaged over the world they give pgx's
gradients, and the penalty's input gradient (of D's scores summed, which
every model rank differentiates) is taken of the sum over ``n_model``.  A
stage ``tp.use_spatial_sharding`` refuses runs as the ``(world, 1)`` grid:
each rank its own rows of the world.

Spans (``pgx_torch.utils.trace``, recorded under a profiler or after
``trace.enable()``) mark the phases of each iteration: ``train.iteration``
around it, ``train.ada_pipe`` around each forward application of the pipe
(``which``: ``real``, ``d_fake``, ``g_fake``), ``train.d_step`` (the fake
pass that feeds D, D's loss and its gradients), ``train.penalty`` inside it
(D on x_hat, the input gradient and its norms; under ``d_concat``, whose
joint pass scores x_hat outside it, the input gradient and its norms alone;
the jvp form whole), ``train.g_step``
(G's loss and gradients) and ``train.optimizer`` (Adam, and for G the EMA);
a window adds ``train.draws`` around the caller's ``draws(j, real)``.  None
sits inside a checkpoint region, so a recomputation records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.utils.checkpoint
from torch.func import functional_call

import torch.distributed as dist

from pgx_torch.augment.adaptive import AdaConfig, ada_update, init_ada_state
from pgx_torch.augment.pipe import (AugmentConfig, RankRows, TorchDraws,
                                    augment_pipe)
from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig
from pgx_torch.models.discriminator import Discriminator, init_discriminator
from pgx_torch.models.generator import (Generator, _state_dict_of,
                                        generator_apply, init_generator)
from pgx_torch.parallel import tp
from pgx_torch.parallel.collectives import (all_reduce_sum, gather_rows,
                                            rank, split_rows, world_size)
from pgx_torch.utils import resolve_device, trace

METRICS = ("d_loss", "grad_penalty", "real_score", "fake_score", "d_total",
           "ada_p", "ada_r", "g_loss")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the WGAN-GP loop (reference defaults); the fields
    of ``pgx.train.TrainConfig``."""

    learning_rate: float = 1e-3
    beta1: float = 0.0
    beta2: float = 0.99
    adam_eps: float = 1e-8
    lambda_gp: float = 10.0
    drift: float = 1e-3
    ema_decay: float = 0.999
    n_critic: int = 1
    gp_every: int = 1      # lazy regularization: the penalty every N
                           # iterations with lambda scaled by N
    gp_mode: str = "reverse"    # 'reverse': the double backward; 'jvp':
                                # reverse over a dual forward (same math)
    remat: bool = False         # recompute activations in the backward
    remat_policy: str = "full"  # 'full' G and D forwards, 'd_only' D's,
                                # 'convs' no region: the kernels' own
                                # Functions keep only the conv outputs
    weights_cast: str = "site"  # 'once': one compute-dtype copy of the
                                # parameters per forward of each state
    fused_g: bool = False
    # One joint gradient pass through D(G(z)) yields the D gradient and,
    # negated, the G gradient.  G is then scored by the PRE-update D, and
    # the logged g_loss is minus the D step's fake score.
    d_concat: bool = False
    # One D forward over cat([real, fake, x_hat]) (3B; 2B when the penalty
    # is skipped) with the minibatch-stddev statistic per B-slice, so each
    # slice scores as a separate call would.  Reverse GP only; incompatible
    # with fused_g.

    def __post_init__(self):
        if self.gp_mode not in ("reverse", "jvp"):
            raise ValueError(f"gp_mode must be 'reverse' or 'jvp', "
                             f"got {self.gp_mode!r}")
        if self.weights_cast not in ("site", "once"):
            raise ValueError(f"weights_cast must be 'site' or 'once', "
                             f"got {self.weights_cast!r}")
        if self.remat_policy not in ("full", "convs", "d_only"):
            raise ValueError(f"remat_policy must be 'full', 'convs' or "
                             f"'d_only', got {self.remat_policy!r}")
        if self.gp_every < 1 or self.n_critic < 1:
            raise ValueError("gp_every and n_critic must be >= 1")
        if self.d_concat and self.gp_mode != "reverse":
            raise ValueError("d_concat requires gp_mode='reverse'")
        if self.d_concat and self.fused_g:
            raise ValueError("d_concat is incompatible with fused_g")


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def _adam_init(module: torch.nn.Module) -> Dict[str, Any]:
    named = dict(module.named_parameters())
    return {"count": 0,
            "mu": {n: torch.zeros_like(p) for n, p in named.items()},
            "nu": {n: torch.zeros_like(p) for n, p in named.items()}}


def _build_state(g: Generator, d: Discriminator, g_ema: Generator,
                 iteration: int = 0) -> Dict[str, Any]:
    device = next(g.parameters()).device
    return {"g": g, "d": d, "g_ema": g_ema, "opt_g": _adam_init(g),
            "opt_d": _adam_init(d), "iteration": iteration,
            "ada": init_ada_state(0.0, device)}


def init_train_state(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
                     tc: TrainConfig, seed: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """The full training state on ``device``: trainable ``g`` and ``d``,
    the frozen EMA copy ``g_ema`` (an exact copy of ``g``), zeroed Adam
    moments and counts, ``iteration`` 0, the ADA controller's state at
    ``p = 0``.  Weights come from
    ``init_generator(gcfg, seed)`` and ``init_discriminator(dcfg,
    seed + 1)``."""
    del tc   # the optimizer's state does not depend on its hyperparameters
    g_tree = init_generator(gcfg, seed)
    return _build_state(
        Generator.from_jax_params(gcfg, g_tree, device, trainable=True),
        Discriminator.from_jax_params(dcfg, init_discriminator(dcfg,
                                                               seed + 1),
                                      device),
        Generator.from_jax_params(gcfg, g_tree, device))


def train_state_from_jax(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
                         tc: TrainConfig, state: Dict[str, Any],
                         device="cuda") -> Dict[str, Any]:
    """Carry a ``jax.device_get`` of pgx's train state across: ``g``, ``d``,
    ``g_ema``, optax's Adam state (``count``, ``mu``, ``nu`` of ``opt_g``
    and ``opt_d``), ``iteration`` and the ADA controller's ``ada`` (``p``,
    ``sign_sum``, ``count``), each in the arrays' own dtype.  ``rng`` is not
    carried: the port's step takes its draws as inputs."""
    del tc
    dev = resolve_device(device)
    out = _build_state(
        Generator.from_jax_params(gcfg, state["g"], dev, trainable=True),
        Discriminator.from_jax_params(dcfg, state["d"], dev),
        Generator.from_jax_params(gcfg, state["g_ema"], dev),
        int(state["iteration"]))
    for key in ("opt_g", "opt_d"):
        adam = state[key][0]        # optax.adam: (ScaleByAdamState, Empty)
        opt = out[key]
        opt["count"] = int(adam.count)
        for moment in ("mu", "nu"):
            flat = _state_dict_of(getattr(adam, moment))
            if flat.keys() != opt[moment].keys():
                raise ValueError(f"{key}.{moment} does not match the "
                                 f"parameters: {sorted(flat)}")
            opt[moment] = {n: flat[n].to(dev) for n in opt[moment]}
    if state["ada"].keys() != out["ada"].keys():
        raise ValueError(f"ada state has keys {sorted(state['ada'])}")
    out["ada"] = {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
                  for k, v in state["ada"].items()}
    return out


def draw_z_eps(gcfg: GeneratorConfig, batch: int, rng: torch.Generator,
               dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's draws on ``rng``'s device: z ~ N(0, 1) of (batch, z_dim)
    in f32 and the interpolation weights eps ~ U[0, 1) of (batch, 1, 1, 1)
    in ``dtype`` (the real batch's)."""
    z = torch.randn(batch, gcfg.z_dim, generator=rng, device=rng.device)
    eps = torch.rand(batch, 1, 1, 1, generator=rng, device=rng.device,
                     dtype=dtype)
    return z, eps


def draw_augment_sources(rng: torch.Generator
                         ) -> Tuple[TorchDraws, TorchDraws, TorchDraws]:
    """One step's three augmentation draw sources (reals, the D step's
    fakes, the G step's fakes) over ``rng``.  They share the generator's
    stream, so each pipe call consumes fresh numbers in call order."""
    return TorchDraws(rng), TorchDraws(rng), TorchDraws(rng)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _grads_of(loss: torch.Tensor,
              params: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params; a parameter off the graph gets zeros, as optax
    sees it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


@torch.no_grad()
def _adam_update(module: torch.nn.Module, grads: List[torch.Tensor],
                 opt: Dict[str, Any], tc: TrainConfig,
                 shards: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """optax.adam's update, in place: bias-corrected moments on one shared
    step count, eps outside the square root.  ``shards``: the blocks a
    sharded module's parameters keep at rest, updated in their place."""
    shards = shards or {}
    names = [n for n, _ in module.named_parameters()]
    params = [shards.get(n, p) for n, p in module.named_parameters()]
    mu = [opt["mu"][n] for n in names]
    nu = [opt["nu"][n] for n in names]
    opt["count"] += 1
    torch._foreach_mul_(mu, tc.beta1)
    torch._foreach_add_(mu, grads, alpha=1.0 - tc.beta1)
    torch._foreach_mul_(nu, tc.beta2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - tc.beta2)
    bc1 = 1.0 - tc.beta1 ** opt["count"]
    bc2 = 1.0 - tc.beta2 ** opt["count"]
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, tc.adam_eps)
    torch._foreach_addcdiv_(params, mu, denom, value=-tc.learning_rate / bc1)


@torch.no_grad()
def _mean_over_ranks(metrics: Dict[str, torch.Tensor], group,
                     world: int) -> None:
    """The batch metrics replaced by their mean over the ranks (one
    all-reduce; the controller's ``ada_p`` is the same on every rank)."""
    names = [k for k in METRICS if k != "ada_p"]
    acc = torch.float32
    for k in names:
        acc = torch.promote_types(acc, metrics[k].dtype)
    flat = torch.stack([metrics[k].to(acc) for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / world
    for i, k in enumerate(names):
        metrics[k] = flat[i].to(metrics[k].dtype)


def _cast(module: torch.nn.Module, dtype: torch.dtype,
          detach: bool = False) -> Dict[str, torch.Tensor]:
    """``weights_cast='once'``: one ``dtype`` copy of each parameter,
    differentiable back to the f32 master unless ``detach``."""
    return {n: (p.detach() if detach else p).to(dtype)
            for n, p in module.named_parameters()}


def _checkpoint_region(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (non-reentrant; the forwards draw no random numbers)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """``module``'s parameters out of the graph for the enclosed forward:
    no gradient is computed or kept for them."""
    module.requires_grad_(False)
    try:
        yield
    finally:
        module.requires_grad_(True)


def make_train_step(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
                    tc: TrainConfig, *, step: int, fading: bool,
                    update_g: bool = True, apply_gp: bool = True,
                    augment_cfg: Optional[AugmentConfig] = None,
                    ada_cfg: Optional[AdaConfig] = None,
                    augment_p: float = 1.0, process_group=None,
                    mesh: Optional[tp.Mesh2D] = None):
    """The train step for one (stage, fade phase):
    ``fn(state, real, labels, alpha, *, z, eps, aug_draws=None)
    -> (state, metrics)``.

    ``real`` is NHWC in [-1, 1] at this stage's resolution; ``labels`` may
    be None for unconditional configs; ``alpha`` is the fade weight; ``z``
    (B, z_dim) and ``eps`` (B, 1, 1, 1) are this step's draws
    (``draw_z_eps``).  ``update_g=False`` is a D-only iteration of the
    ``n_critic`` cadence; ``apply_gp=False`` skips the penalty (lazy
    regularization, ``gp_every > 1``).  The state is updated in place and
    returned; ``metrics`` maps ``METRICS`` to 0-d tensors on the device (no
    host synchronization happens in the step).

    When ``augment_cfg`` is given, the ADA pipeline augments every image D
    sees, differentiable through to G, and the step needs ``aug_draws``:
    three draw sources for the reals, the D step's fakes and the G step's
    fakes (``draw_augment_sources``).  With ``ada_cfg`` the controller in
    ``state["ada"]`` drives the probability from the real logits; without
    it the fixed ``augment_p`` applies (the controller's p starts at 0,
    which would make ``augment_cfg`` alone do nothing).  With ``fused_g``
    G's gradient sees the D step's draw, as in pgx.

    ``process_group`` (a ``torch.distributed`` group, every rank calling
    the step in step): ``real`` and ``labels`` are this rank's rows of the
    global batch, ``z`` and ``eps`` the global batch's draws (the same on
    every rank; the step keeps its rows) and ``aug_draws`` sources of the
    global batch's draws; the result is pgx's step at the global batch
    (module docstring).

    ``mesh`` (a ``tp.Mesh2D``, in place of ``process_group``): the same
    over the grid's world group, on a state ``tp.shard_state`` sharded
    over its model axis; in spatial mode on a whole state, ``real`` and
    ``labels`` this rank's part under ``tp.spatial_batch_sharding`` (the
    rows of its data position, its rows of H), or at a stage
    ``tp.use_spatial_sharding`` refuses its rows of the world (module
    docstring)."""
    if mesh is not None:
        if process_group is not None:
            raise ValueError("pass mesh= or process_group=, not both")
        group = mesh.world_group if mesh.world > 1 else None
    else:
        # pure data parallelism: the (world, 1) grid, nothing sharded
        group = process_group
        mesh = (tp.Mesh2D(1, 1) if group is None else
                tp.Mesh2D(world_size(group), 1, rank(group), 0, group))
    spatial = tp.spatial_active(mesh, gcfg.resolution(step))
    if mesh.mode == "spatial" and not spatial:
        # batch-only placement: the (world, 1) grid, nothing sharded
        mesh = tp.Mesh2D(mesh.world, 1, mesh.rank, 0, group, mode="spatial")
    sharded = mesh.n_model > 1 and mesh.mode == "channels"
    world, me = mesh.world, mesh.rank
    # spatial: the images' rows split over the model group, whose ranks
    # share their batch rows: the batch is split over the data positions
    rows = mesh if spatial else None
    batch_ranks, batch_pos = ((mesh.n_data, mesh.d) if spatial
                              else (world, me))
    batch_group = ((mesh.data_group if mesh.n_data > 1 else None)
                   if spatial else group)
    conditional = gcfg.conditioning != "none"
    fused = bool(tc.fused_g) and update_g
    lam = tc.lambda_gp * tc.gp_every
    policy = tc.remat_policy if tc.remat else None
    g_dtype, d_dtype = gcfg.compute_dtype, dcfg.compute_dtype

    def cast_of(module, dtype, detach=False):
        """The parameters a forward runs on: the module's own (None), or
        with weights_cast='once' one compute-dtype copy (f32: the
        masters, as in pgx)."""
        if tc.weights_cast != "once" or dtype == torch.float32:
            return None
        return _cast(module, dtype, detach)

    def train_step(state, real, labels, alpha, *, z, eps, aug_draws=None):
        with trace.span("train.iteration", iteration=state["iteration"],
                        penalty=apply_gp):
            if not sharded:
                return step_body(state, real, labels, alpha, z, eps,
                                 aug_draws)
            gen, disc = state["g"], state["d"]
            if not (tp.sharded_names(gen) and tp.sharded_names(disc)):
                raise ValueError("a mesh with a model axis needs a state "
                                 "that tp.shard_state sharded")
            # the blocks at rest are the master weights; the whole
            # parameters live for this step only
            blocks = tp.unshard_(mesh, (gen, disc))
            try:
                return step_body(state, real, labels, alpha, z, eps,
                                 aug_draws, blocks)
            finally:
                tp.reshard_(gen, blocks[0])
                tp.reshard_(disc, blocks[1])

    def step_body(state, real, labels, alpha, z, eps, aug_draws,
                  blocks=({}, {})):
        gen, disc = state["g"], state["d"]
        lab = labels if conditional else None
        bsz = real.shape[0]
        if group is not None:
            # the global batch's draws: this rank's rows
            n = bsz * batch_ranks
            if z.shape[0] != n or eps.shape[0] != n:
                raise ValueError(
                    f"with a process group z and eps are the global "
                    f"batch's draws ({bsz} rows x {batch_ranks} ranks), "
                    f"got {z.shape[0]} and {eps.shape[0]}")
            z = z[batch_pos * bsz:(batch_pos + 1) * bsz]
            eps = eps[batch_pos * bsz:(batch_pos + 1) * bsz]

        if augment_cfg is not None:
            if aug_draws is None or len(aug_draws) != 3:
                raise ValueError("augment_cfg needs aug_draws: three draw "
                                 "sources (draw_augment_sources)")
            if group is not None:
                aug_draws = [RankRows(d, batch_pos, batch_ranks)
                             for d in aug_draws]
            ada_p = (state["ada"]["p"] if ada_cfg is not None
                     else torch.full((), augment_p, dtype=torch.float32,
                                     device=real.device))
            draws_real, draws_d_fake, draws_g_fake = aug_draws

            def pipe(draws, img, which):
                # spatial: the warp moves rows across the cut, so it runs
                # on whole images, alike on every model rank
                with trace.span("train.ada_pipe", which=which):
                    if rows is None:
                        return augment_pipe(draws, img, augment_cfg, ada_p)
                    return split_rows(augment_pipe(
                        draws, gather_rows(img, rows), augment_cfg, ada_p),
                        rows)
            with torch.no_grad():
                real = pipe(draws_real, real, "real")
            # every application of the pipe draws fresh transforms: the G
            # step redraws rather than optimize G against the one transform
            # D happened to see
            aug_d_fake = lambda img: pipe(draws_d_fake, img, "d_fake")
            aug_g_fake = lambda img: pipe(draws_g_fake, img, "g_fake")
        else:
            aug_d_fake = aug_g_fake = lambda img: img

        def g_apply(g_params):
            kw = dict(step=step, alpha=alpha, fading=fading, rows=rows)
            if g_params is None:
                return generator_apply(gen, z, lab, **kw)
            return functional_call(gen, g_params, (z, lab), kw)

        def d_apply(img, d_params, groups=1):
            lab_c = None if lab is None else torch.cat([lab] * groups)
            kw = dict(step=step, alpha=alpha, fading=fading,
                      stddev_groups=groups, stddev_group=batch_group,
                      rows=rows)
            if d_params is None:
                out = disc(img, lab_c, **kw)
            else:
                out = functional_call(disc, d_params, (img, lab_c), kw)
            return out.reshape(-1)

        def d_jvp_apply(x_hat, u, d_params, d_fwd=d_apply):
            """sum(D(x_hat)) differentiated forward along u, returned as a
            plain tensor (what a checkpoint region may return).  It runs
            the bare forward: a dual tensor may not enter a region."""
            with fwAD.dual_level():
                out = d_fwd(fwAD.make_dual(x_hat, u), d_params)
                return fwAD.unpack_dual(out.sum()).tangent

        if policy == "full":
            g_apply = functools.partial(_checkpoint_region, g_apply)
        if policy in ("full", "d_only"):
            d_apply = functools.partial(_checkpoint_region, d_apply)
            d_jvp_apply = functools.partial(_checkpoint_region, d_jvp_apply)

        def norms_of(grad_x):
            acc = torch.promote_types(grad_x.dtype, torch.float32)
            gx = grad_x.to(acc)
            ssq = torch.sum(torch.square(gx), dim=(1, 2, 3))
            if rows is not None:
                # each rank's rows: the squared norm's partial sums
                ssq = all_reduce_sum(ssq, mesh.model_group)
            return gx, torch.sqrt(ssq)

        def summed(scores):
            # the scalar an input gradient is taken of; spatial: every
            # model rank differentiates it, so each takes 1 / n_model
            if rows is None:
                return scores.sum()
            return scores.sum() / mesh.n_model

        def penalty(norms):
            return lam * torch.mean(torch.square(norms - 1.0))

        def jvp_penalty(x_hat, d_params):
            # grad_x only builds the detached coefficient u: D's
            # parameters are frozen there (pgx's pd_sg), so no weight or
            # bias gradient is computed and no graph is kept
            xh = x_hat.detach().requires_grad_(True)
            with _frozen(disc):
                frozen = (None if d_params is None
                          else {n: p.detach() for n, p in d_params.items()})
                grad_x, = torch.autograd.grad(summed(d_apply(xh, frozen)),
                                              xh)
            gx, norms = norms_of(grad_x)
            gp_value = penalty(norms)
            coef = 2.0 * lam * (norms - 1.0) / (norms * bsz)
            u = (coef[:, None, None, None] * gx).to(x_hat.dtype).detach()
            jv = d_jvp_apply(x_hat.detach(), u, d_params)
            # value: the true penalty; gradient: the surrogate's
            return gp_value.detach() + (jv - jv.detach())

        def d_loss_with(fake_live, d_params):
            # fake_live carries G's graph in fused mode; x_hat never does:
            # the reference interpolates against a detached fake
            x_hat = eps * real + (1.0 - eps) * fake_live.detach()
            gp = torch.zeros((), dtype=torch.float32, device=real.device)
            if tc.d_concat:
                # one batched forward with per-slice stddev; the hat
                # slice's input gradient comes from the same graph
                parts = [real, fake_live]
                if apply_gp:
                    parts.append(x_hat.requires_grad_(True))
                scores = d_apply(torch.cat(parts, dim=0), d_params,
                                 len(parts))
                real_scores = scores[:bsz]
                fake_scores = scores[bsz:2 * bsz]
                if apply_gp:
                    with trace.span("train.penalty"):
                        grad_x, = torch.autograd.grad(
                            summed(scores[2 * bsz:]), x_hat,
                            create_graph=True)
                        gp = penalty(norms_of(grad_x)[1])
            else:
                real_scores = d_apply(real, d_params)
                fake_scores = d_apply(fake_live, d_params)
                if apply_gp:
                    with trace.span("train.penalty"):
                        if tc.gp_mode == "jvp":
                            gp = jvp_penalty(x_hat, d_params)
                        else:
                            x_hat.requires_grad_(True)
                            grad_x, = torch.autograd.grad(
                                summed(d_apply(x_hat, d_params)), x_hat,
                                create_graph=True)
                            gp = penalty(norms_of(grad_x)[1])
            real_drifted = (torch.mean(real_scores) - tc.drift
                            * torch.mean(torch.square(real_scores)))
            loss = -real_drifted + torch.mean(fake_scores) + gp
            aux = {"d_loss": real_drifted - torch.mean(fake_scores),
                   "grad_penalty": gp,
                   "real_score": torch.mean(real_scores),
                   "fake_score": torch.mean(fake_scores),
                   "d_total": loss,
                   "ada_r": torch.mean(torch.sign(real_scores))}
            return (loss, {k: v.detach() for k, v in aux.items()},
                    real_scores.detach())

        # G's parameters do not change before its own update: one copy
        # serves the D step's fake pass and the G step
        g_params = cast_of(gen, g_dtype)

        # --- D update (its graph dies with this function's locals) --------
        def d_step():
            d_params = list(disc.parameters())
            d_cast = cast_of(disc, d_dtype)
            if fused:
                gp_list = list(gen.parameters())
                loss, aux, logits = d_loss_with(
                    aug_d_fake(g_apply(g_params)), d_cast)
                grads = tp.reduce_gradients(
                    mesh, (disc, gen), _grads_of(loss, d_params + gp_list))
                return (grads[:len(d_params)],
                        [-g for g in grads[len(d_params):]], aux, logits)
            with torch.no_grad():
                fake = aug_d_fake(g_apply(g_params))
            loss, aux, logits = d_loss_with(fake, d_cast)
            grads = tp.reduce_gradients(mesh, (disc,),
                                        _grads_of(loss, d_params))
            return grads, None, aux, logits

        with trace.span("train.d_step"):
            d_grads, g_grads, metrics, real_logits = d_step()
        with trace.span("train.optimizer", net="d"):
            _adam_update(disc, d_grads, state["opt_d"], tc, blocks[1])
        del d_grads
        if sharded and update_g and not fused:
            # the G step scores G against the updated D: gather it again
            tp.unshard_(mesh, (disc,), (blocks[1],))

        if augment_cfg is not None and ada_cfg is not None:
            state["ada"] = ada_update(state["ada"], real_logits, ada_cfg,
                                      bsz * batch_ranks, group=batch_group)
        # the probability actually applied: the controller's when ADA drives
        # it, the fixed augment_p when augmentation runs without a
        # controller (whose p stays 0 there)
        metrics["ada_p"] = (ada_p if augment_cfg is not None
                            and ada_cfg is None else state["ada"]["p"])
        metrics["g_loss"] = torch.zeros((), device=real.device)

        # --- G update: same z, the updated D (fused: the joint pass's
        # negated gradient against the pre-update D) -----------------------
        if update_g:
            with trace.span("train.g_step", fused=fused):
                if fused:
                    metrics["g_loss"] = -metrics["fake_score"]
                else:
                    with _frozen(disc):
                        # the updated D: cast again (weights_cast='once')
                        g_loss = -torch.mean(d_apply(
                            aug_g_fake(g_apply(g_params)),
                            cast_of(disc, d_dtype)))
                        g_grads = tp.reduce_gradients(
                            mesh, (gen,),
                            _grads_of(g_loss, list(gen.parameters())))
                    metrics["g_loss"] = g_loss.detach()
                    del g_loss
            with trace.span("train.optimizer", net="g"), torch.no_grad():
                _adam_update(gen, g_grads, state["opt_g"], tc, blocks[0])
                ema = list(state["g_ema"].parameters())
                torch._foreach_mul_(ema, tc.ema_decay)
                torch._foreach_add_(
                    ema, [blocks[0].get(n, p)
                          for n, p in gen.named_parameters()],
                    alpha=1.0 - tc.ema_decay)
        if group is not None:
            _mean_over_ranks(metrics, group, world)
        state["iteration"] += 1
        return state, metrics

    return train_step


def make_train_multi_step(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
                          tc: TrainConfig, *, step: int, fading: bool,
                          k: int, augment_cfg: Optional[AugmentConfig] = None,
                          ada_cfg: Optional[AdaConfig] = None,
                          augment_p: float = 1.0, process_group=None,
                          mesh: Optional[tp.Mesh2D] = None):
    """``k`` iterations in one call (counterpart of pgx's scanned
    ``make_train_multi_step``):
    ``fn(state, reals, labels, alphas, *, draws) -> (state, summed_metrics)``.

    ``reals`` is a k-sequence of batches, ``labels`` a k-sequence or None,
    ``alphas`` k fade weights.  ``draws`` gives each iteration's ``(z, eps,
    aug_draws)``: a k-sequence, or a callable ``draws(j, real)`` called just
    before iteration j runs, so a generator's numbers are consumed in the
    order k single steps would consume them.  The window runs
    ``k / gp_every`` groups of one penalty iteration and ``gp_every - 1``
    plain ones (it must start on a ``gp_every`` boundary, as pgx's), each
    the single step's body; the metrics are summed on the device and
    nothing synchronizes the host inside the window.  Constraints as pgx's:
    ``n_critic == 1`` and ``k`` a positive multiple of ``gp_every``.
    ``process_group`` / ``mesh``: each iteration is the single step's over
    the group or the grid (``make_train_step``), its draws the global
    batch's."""
    if tc.n_critic != 1:
        raise ValueError("multi-step dispatch requires n_critic == 1")
    if k < 1 or k % tc.gp_every != 0:
        raise ValueError(f"k={k} must be a positive multiple of "
                         f"gp_every={tc.gp_every}")
    mk = lambda gp: make_train_step(
        gcfg, dcfg, tc, step=step, fading=fading, update_g=True,
        apply_gp=gp, augment_cfg=augment_cfg, ada_cfg=ada_cfg,
        augment_p=augment_p, process_group=process_group, mesh=mesh)
    body_gp = mk(True)
    body_plain = mk(False) if tc.gp_every > 1 else body_gp

    def multi_step(state, reals: Sequence[torch.Tensor], labels,
                   alphas: Sequence[float], *, draws):
        if not len(reals) == len(alphas) == k:
            raise ValueError(f"a window of k={k} needs k batches and "
                             f"alphas, got {len(reals)} and {len(alphas)}")
        sums = None
        for j in range(k):
            real = reals[j]
            if callable(draws):
                with trace.span("train.draws"):
                    z, eps, aug = draws(j, real)
            else:
                z, eps, aug = draws[j]
            body = body_gp if j % tc.gp_every == 0 else body_plain
            state, m = body(state, real,
                            None if labels is None else labels[j],
                            float(alphas[j]), z=z, eps=eps, aug_draws=aug)
            # summed as the loop sums: in f32 (or wider)
            m = {n: v.to(torch.promote_types(v.dtype, torch.float32))
                 for n, v in m.items()}
            sums = m if sums is None else {n: sums[n] + v
                                           for n, v in m.items()}
        return state, sums

    return multi_step


def make_eval_generate(gcfg: GeneratorConfig, *, step: int,
                       fading: bool = False, output: str = "float"):
    """Sampling function ``generate(gen, z, labels=None, alpha=1.0)`` shared
    by the serving path, running under ``torch.inference_mode``.

    ``output='uint8'`` quantizes on the device with
    ``floor((clip(x, -1, 1) + 1) / 2 * 255 + 0.5)`` in f32, bit-matching
    ``pgx_torch.utils.png.to_uint8``, so a host fetches 4x fewer bytes."""
    return torch.inference_mode()(eval_forward(gcfg, step=step,
                                               fading=fading, output=output))


def eval_forward(gcfg: GeneratorConfig, *, step: int, fading: bool = False,
                 output: str = "float"):
    """``make_eval_generate``'s function without its ``inference_mode``:
    what ``pgx_torch.export`` traces (under ``torch.no_grad``)."""
    if output not in ("float", "uint8"):
        raise ValueError(f"output must be 'float' or 'uint8', got {output!r}")

    def generate(gen, z, labels=None, alpha=1.0):
        lab = labels if gcfg.conditioning != "none" else None
        img = generator_apply(gen, z, lab, step=step, alpha=alpha,
                              fading=fading)
        if output == "uint8":
            x = (torch.clamp(img.float(), -1.0, 1.0) + 1.0) * 0.5
            img = torch.floor(x * 255.0 + 0.5).to(torch.uint8)
        return img
    return generate
