"""The host-side training loop (counterpart of ``pgx/train/loop.py``).

Orchestrates: growth schedule -> per-stage train steps (one per (step,
fading, update_g, apply_gp)) -> prefetched data -> periodic sample grids,
checkpoints, and CSV/console logging, with full-state resume.  The trial
directory, its file names, the CSV and ``timing.json`` are ``pgx``'s.

Design notes (CUDA):
* metrics are summed on the device between log ticks; the host reads them
  only at a tick (no per-iteration synchronization).  The step itself
  enqueues its kernels asynchronously, so the numpy batch prep and the
  upload (``DevicePrefetcher``) overlap with the device's work.
* the step updates the state in place, so an interrupt inside it would
  leave a half-updated state: SIGTERM, and SIGINT while a step runs, are
  deferred to the next iteration (or window) boundary, where the emergency
  checkpoint is written.
* ``steps_per_call=k`` runs windows of k iterations through
  ``make_train_multi_step`` under pgx's ``_scan_window`` rules; ``0``
  (auto) times a few single steps at each stage start and picks k with
  pgx's ``_auto_k`` rule.
* ``pgx`` draws z, eps and the augmentation sources from ``state["rng"]``
  inside its step; here the loop draws them from a ``torch.Generator`` it
  keeps in ``state["rng"]`` (saved in the full state) and hands them to
  the step.  ``draws=`` replaces that source (a test replays ``pgx``'s key
  chain through it).
* over a process group (``torch.distributed`` initialized with more than
  one rank, one process per rank: ``pgx_torch.parallel.
  initialize_multihost``), ``batch_size`` and the stage batches are
  global: each rank feeds its rows from a data stream seeded
  ``seed + 104729 * rank`` (pgx's per-host offset), the draws are the
  global batch's from the same generator on every rank, and the step's
  collectives make it pgx's step at the global batch.  Rank 0 alone reads
  a resumed trial (configs, schedule and state broadcast to the others)
  and writes checkpoints, grids, logs, ``timing.json``, the store and the
  FID ticks; every rank enters every step, and the state is replicated
  from rank 0 at the start.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.checkpoint.step_store import StepStateStore, has_step_state
from pgx_torch.data.pipeline import DevicePrefetcher, array_batches
from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig
from pgx_torch.models.generator import _state_dict_of
from pgx_torch.parallel import collectives as coll
from pgx_torch.parallel.distributed import broadcast_obj, host_batch_slice
from pgx_torch.parallel.mesh import make_mesh_for_batch, replicate
from pgx_torch.train.schedule import schedule_from_dict, schedule_to_dict
from pgx_torch.train.wgan import (TrainConfig, draw_augment_sources,
                                  draw_z_eps, init_train_state,
                                  make_eval_generate, make_train_multi_step,
                                  make_train_step)
from pgx_torch.utils import resolve_device
from pgx_torch.utils.png import save_image_grid


@dataclasses.dataclass
class LoopConfig:
    """``pgx.train.loop.LoopConfig``, field for field.  A value whose code
    path is not ported yet raises ``NotImplementedError`` here:
    ``model_parallel > 1`` (tensor and spatial model parallelism).
    ``checkpoint_backend='orbax'`` keeps the full state in the port's
    step-indexed store (``pgx_torch.checkpoint.step_store``: asynchronous
    writes, atomic commits) in place of ``{iter}_state.pt``.  ``use_mesh``
    changes nothing on one device, as ``pgx``'s one-device mesh does; over
    several processes it must stay on.
    ``steps_per_call``: k iterations per call (``make_train_multi_step``),
    1 one per call, 0 auto.  ``fid_every > 0``: the EMA generator's FID
    every that many iterations (``pgx_torch.eval.TrainingFid``, with
    ``fid_samples`` samples and the ``inception_weights`` file)."""

    trial_name: str = "trial"
    main_path: str = "."
    batch_size: int = 4
    sample_every: int = 1000
    checkpoint_every: int = 10000
    log_every: int = 500
    seed: int = 0
    total_iterations: Optional[int] = None
    tail_iterations: int = 0          # final-resolution tail
    sample_rows: int = 5
    sample_cols: int = 10
    keep_full_state: bool = True
    checkpoint_backend: str = "npz"   # "npz" (+ the torch.save full state)
                                      # or "orbax" (the step-indexed store)
    fid_every: int = 0
    fid_samples: int = 1024
    inception_weights: Optional[str] = None
    use_mesh: bool = True
    steps_per_call: int = 1         # a window of N iterations per call
                                    # (make_train_multi_step); 0 == auto:
                                    # time single steps at each stage start
                                    # and pick the window (_auto_k).  An
                                    # interrupt lands after the window
    model_parallel: int = 1
    model_parallel_mode: str = "channels"
    verbose: bool = True
    snapshot_sources: bool = True

    def __post_init__(self):
        if self.checkpoint_backend not in ("npz", "orbax"):
            raise ValueError(f"checkpoint_backend must be 'npz' or 'orbax', "
                             f"got {self.checkpoint_backend!r}")
        if self.steps_per_call < 0:
            raise ValueError(f"steps_per_call must be >= 0 (0: auto), got "
                             f"{self.steps_per_call}")
        if self.model_parallel > 1:
            raise NotImplementedError(
                f"LoopConfig.model_parallel={self.model_parallel!r} is not "
                f"ported yet")


def make_trial_dir(loop_cfg: LoopConfig) -> Tuple[str, str]:
    """trial_{name}_{date}_{hour}_{minute} layout."""
    now = datetime.datetime.now()
    postfix = f"{loop_cfg.trial_name}_{now.date()}_{now.hour}_{now.minute}"
    trial_dir = os.path.join(loop_cfg.main_path, f"trial_{postfix}")
    os.makedirs(os.path.join(trial_dir, "checkpoint"), exist_ok=True)
    os.makedirs(os.path.join(trial_dir, "sample"), exist_ok=True)
    return trial_dir, postfix


def _sample_grid_inputs(gcfg: GeneratorConfig, loop_cfg: LoopConfig,
                        rng: np.random.RandomState):
    if gcfg.conditioning != "none":
        c = gcfg.num_classes
        labels = np.repeat(np.arange(c), c)     # C rows, one class per row
        z = rng.randn(c * c, gcfg.z_dim).astype(np.float32)
        return z, labels, c
    n = loop_cfg.sample_rows * loop_cfg.sample_cols
    z = rng.randn(n, gcfg.z_dim).astype(np.float32)
    return z, None, loop_cfg.sample_cols


def _scan_window(i: int, st, schedule, total: int, tc: TrainConfig,
                 loop_cfg: LoopConfig, k: int) -> int:
    """How many iterations starting at ``i`` run as one window: the full
    ``k``, or 1 (a single step).  pgx's rules: a window never crosses a
    sample, checkpoint or log boundary (events fire at the window's end, as
    at the single-step cadence), stays inside one (stage, fade phase,
    resolution), starts ``gp_every``-aligned and never overruns ``total``."""
    if i % tc.gp_every != 0 or k % tc.gp_every != 0 or i + k > total:
        return 1
    events = [loop_cfg.sample_every, loop_cfg.checkpoint_every,
              loop_cfg.log_every]
    if loop_cfg.fid_every > 0:
        events.append(loop_cfg.fid_every)
    for every in events:
        # the next event strictly inside (i, i + k): no window past it
        if ((i // every) + 1) * every < i + k:
            return 1
    for j in range(1, k):
        s2 = schedule.state_at(i + j)
        if ((s2.step, s2.fading, s2.resolution)
                != (st.step, st.fading, st.resolution)):
            return 1
    return k


def _auto_k(ms: float, gp_every: int) -> int:
    """pgx's window for a measured single-step time ``ms``: 16 below 20 ms,
    8 below 60 ms, else 1; capped so one window stays under ~5 s (an
    interrupt lands only after the window), and a multiple of
    ``gp_every``."""
    base = 16 if ms < 20.0 else (8 if ms < 60.0 else 1)
    if base == 1:
        return 1
    base = min(base, max(1, int(5000.0 / max(ms, 1e-3))))
    return max(gp_every * max(1, base // gp_every), 1)


def _load_newest_state(trial_dir: str, state):
    """Restore the newest full state of ``trial_dir`` into ``state`` and
    return ``(state, start_iter)``: the newer of the newest ``*_state.pt``
    and the step-indexed store's newest step (the store on a tie), as a
    trial may hold both (trained with one backend, resumed with the other).
    Without either, resume is model-only from the newest npz pair: the EMA
    generator goes into both ``g`` and ``g_ema``, Adam stays fresh, the
    iteration comes from the file name."""
    ckpt_dir = os.path.join(trial_dir, "checkpoint")
    state_files = sorted(
        (f for f in os.listdir(ckpt_dir) if f.endswith("_state.pt")),
        key=lambda n: int(n.split("_")[0]))
    file_it = int(state_files[-1].split("_")[0]) if state_files else -1
    if has_step_state(trial_dir):
        store = StepStateStore(trial_dir, async_save=False)
        store_it = store.latest_iteration()
        if store_it >= file_it:
            store.restore(store_it, state)
            return state, state["iteration"]
    if state_files:
        ckpt.load_state(os.path.join(ckpt_dir, state_files[-1]), state)
        return state, state["iteration"]
    gpath = ckpt.latest_checkpoint(trial_dir, "g")
    dpath = ckpt.latest_checkpoint(trial_dir, "d")
    if gpath is None or dpath is None:
        raise FileNotFoundError(f"no checkpoints in {trial_dir}")
    g = ckpt.load_params(gpath)
    for key, tree in (("g", g), ("g_ema", g),
                      ("d", ckpt.load_params(dpath))):
        state[key].load_state_dict(_state_dict_of(tree), strict=True)
    start_iter = ckpt.checkpoint_iteration(gpath)
    state["iteration"] = start_iter
    return state, start_iter


def _augment_recipe(augment_cfg, ada_cfg, augment_p):
    """JSON form of the run's augmentation settings, saved in the trial
    config so that resume can warn on drift."""
    if augment_cfg is None:
        return None
    rec: Dict[str, Any] = {"pipe": dataclasses.asdict(augment_cfg),
                           "mode": ("adaptive" if ada_cfg is not None
                                    else "fixed")}
    if ada_cfg is not None:
        rec["ada"] = dataclasses.asdict(ada_cfg)
    else:
        rec["p"] = float(augment_p)
    return rec


class _Interrupts:
    """SIGTERM (always) and SIGINT (while a step or window runs) deferred to
    the next iteration or window boundary; the previous handlers come back
    on ``restore``.  Handlers install only from the main thread."""

    def __init__(self):
        self.pending: Optional[BaseException] = None
        self.in_step = False
        self._prev = {}
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        if signum == signal.SIGINT and not self.in_step:
            raise KeyboardInterrupt
        if self.pending is None:
            self.pending = (SystemExit(143) if signum == signal.SIGTERM
                            else KeyboardInterrupt())

    def check(self):
        if self.pending is not None:
            raise self.pending

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def train_loop(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
               tc: TrainConfig, schedule, dataset, loop_cfg: LoopConfig,
               resume_dir: Optional[str] = None,
               batch_fn: Callable = array_batches,
               augment_cfg=None, ada_cfg=None, augment_p: float = 1.0,
               hooks: Optional[Dict[str, Callable]] = None,
               device="cuda", draws: Optional[Callable] = None) -> str:
    """Run training on ``device``; returns the trial directory path.
    ``augment_cfg`` / ``ada_cfg`` enable the ADA pipeline and its
    controller.  ``draws(i, real)``, when given, returns iteration ``i``'s
    ``(z, eps, aug_draws)`` in place of the loop's generator (the global
    batch's over a process group).  Over a process group every rank calls
    ``train_loop`` with the same arguments (module docstring); a card
    without an index is the rank's current device."""
    hooks = hooks or {}
    dev = resolve_device(device)
    group = torch.distributed.group.WORLD if coll.active() else None
    n_ranks, my_rank = coll.world_size(group), coll.rank(group)
    is_main = my_rank == 0
    if group is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    aug_recipe = _augment_recipe(augment_cfg, ada_cfg, augment_p)

    # resume trains the trial's saved architecture and growth schedule;
    # the caller's may drift.  Rank 0 alone reads the trial (the others may
    # not see its directory) and broadcasts what it found
    if resume_dir is not None:
        saved = saved_sched = None
        saved_aug = "missing"
        if is_main:
            try:
                cfg_json = ckpt.load_config(resume_dir.rstrip("/"))
                saved = ckpt.configs_from_dict(cfg_json)
                saved_sched = cfg_json.get("schedule")
                saved_aug = cfg_json.get("augment", "missing")
            except (FileNotFoundError, KeyError, TypeError):
                saved = saved_sched = None
        saved, saved_sched, saved_aug = broadcast_obj(
            (saved, saved_sched, saved_aug), group)
        # augmentation comes from the caller, not the saved config; drift
        # against the saved recipe warns (compared through a JSON round
        # trip: tuples come back from disk as lists)
        aug_json = json.loads(json.dumps(aug_recipe))
        if saved_aug != "missing" and saved_aug != aug_json:
            warnings.warn(
                f"resume: augmentation settings differ from the trial's "
                f"saved recipe — saved {saved_aug!r}, configured "
                f"{aug_recipe!r}.  The CONFIGURED settings apply; re-pass "
                f"the original --ada/--ada-p/--ada-warp flags to continue "
                f"the recorded recipe", RuntimeWarning)
        if saved is not None and (saved[0] != gcfg or saved[1] != dcfg):
            warnings.warn(
                "resume: model configs in the trial's train_config JSON "
                "differ from the configured ones; using the saved configs "
                "(reference resume semantics)", RuntimeWarning)
            gcfg, dcfg = saved[0], saved[1]
        if (saved_sched is not None
                and schedule_to_dict(schedule) != saved_sched):
            warnings.warn(
                "resume: growth schedule in the trial's train_config JSON "
                "differs from the configured one; using the saved schedule "
                "— otherwise the resumed iteration would map to a "
                "different (step, alpha, batch)", RuntimeWarning)
            # the saved schedule maps iterations; the caller still decides
            # how long to train
            if loop_cfg.total_iterations is None:
                loop_cfg = dataclasses.replace(
                    loop_cfg, total_iterations=schedule.total_iterations(
                        loop_cfg.tail_iterations))
            schedule = schedule_from_dict(saved_sched)

    # per-stage batch sizes (ProperSchedule.stage_batches); unlisted stages
    # use loop_cfg.batch_size
    _batch_hook = getattr(schedule, "batch_for_step", None)

    def stage_batch_for(step: int) -> int:
        b = _batch_hook(step) if _batch_hook is not None else None
        return int(b) if b else loop_cfg.batch_size

    # the mesh must divide every stage's batch: sized for their gcd
    stage_batches = sorted({
        stage_batch_for(s)
        for s in range(getattr(schedule, "init_step", 1),
                       getattr(schedule, "max_step", 1) + 1)})
    mesh_batch = 0
    for b in stage_batches:
        mesh_batch = math.gcd(mesh_batch, b)
    mesh = None
    if loop_cfg.use_mesh:
        # over several ranks it raises at launch, not when the offending
        # stage begins, unless the ranks divide every stage's batch
        mesh = make_mesh_for_batch(mesh_batch, devices=[dev], group=group)
    elif n_ranks > 1:
        raise ValueError("multi-process training requires use_mesh=True")
    host_seed = loop_cfg.seed + 104729 * my_rank

    def host_batch_for(global_batch: int) -> int:
        """This rank's share of a (per-stage) global batch."""
        return host_batch_slice(global_batch, group)[0]

    state = init_train_state(gcfg, dcfg, tc, seed=loop_cfg.seed, device=dev)
    state["rng"] = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    start_iter = 0
    use_store = loop_cfg.checkpoint_backend == "orbax"
    store: Optional[StepStateStore] = None

    def save_full(it, current_state):
        """One checkpoint write (periodic / interrupt / final): the npz
        pair always; the full state as ``{iter}_state.pt`` or, with the
        store, as its step ``it`` (written in the background).  Rank 0
        alone writes: the state is replicated."""
        nonlocal store
        if not is_main:
            return
        ckpt.save_checkpoint(trial_dir, it, current_state,
                             full_state=loop_cfg.keep_full_state
                             and not use_store)
        if use_store and loop_cfg.keep_full_state:
            if store is None:
                store = StepStateStore(trial_dir)
            store.save(it, current_state)

    if resume_dir is not None:
        trial_dir = resume_dir.rstrip("/")
        base = os.path.basename(trial_dir)
        # the postfix names the CSV this run appends to; a renamed or
        # copied trial keeps its name
        postfix = base[len("trial_"):] if base.startswith("trial_") else base
        load_err = None
        if is_main:
            os.makedirs(os.path.join(trial_dir, "sample"), exist_ok=True)
            os.makedirs(os.path.join(trial_dir, "checkpoint"), exist_ok=True)
            try:
                state, start_iter = _load_newest_state(trial_dir, state)
            except Exception as e:   # raised on every rank below
                if n_ranks == 1:
                    raise
                load_err = f"{type(e).__name__}: {e}"
        load_err, start_iter = broadcast_obj((load_err, start_iter), group)
        if load_err is not None:
            raise RuntimeError(f"resume failed on rank 0: {load_err} "
                               f"(trial dir: {trial_dir})")
    elif not is_main:
        # the other ranks never write; a name for the return value
        trial_dir = os.path.join(loop_cfg.main_path,
                                 f"trial_{loop_cfg.trial_name}_rank"
                                 f"{my_rank}")
        postfix = loop_cfg.trial_name
    else:
        trial_dir, postfix = make_trial_dir(loop_cfg)
        ckpt.save_config(trial_dir, gcfg, dcfg, tc,
                         extra={"batch_size": loop_cfg.batch_size,
                                "seed": loop_cfg.seed,
                                "schedule": schedule_to_dict(schedule),
                                # None for augmentation-free runs, so drift
                                # is detectable either way
                                "augment": aug_recipe},
                         postfix=postfix)
        if loop_cfg.snapshot_sources:
            from pgx_torch.utils.persistence import snapshot_sources
            snapshot_sources(trial_dir)

    if mesh is not None:
        # rank 0's state (the fresh one, or the resumed one) on every rank
        state = replicate(mesh, state)

    log_path = os.path.join(trial_dir, f"train_log_{postfix}.txt")
    log_ada = augment_cfg is not None
    if is_main and not os.path.exists(log_path):
        with open(log_path, "w") as f:
            f.write("iter,g,d,grad,alpha"
                    + (",ada_p,ada_r" if log_ada else "") + "\n")

    total = (loop_cfg.total_iterations
             if loop_cfg.total_iterations is not None
             else schedule.total_iterations(loop_cfg.tail_iterations))

    if draws is None:
        rng = state["rng"]

        def draws(i, real):
            # the global batch's draws: every rank keeps its rows
            z, eps = draw_z_eps(gcfg, real.shape[0] * n_ranks, rng,
                                dtype=real.dtype)
            return z, eps, (draw_augment_sources(rng)
                            if augment_cfg is not None else None)

    step_cache: Dict[Any, Callable] = {}
    gen_cache: Dict[Any, Callable] = {}
    sample_rng = np.random.RandomState(loop_cfg.seed + 1)
    sample_z, sample_labels, sample_nrow = _sample_grid_inputs(
        gcfg, loop_cfg, sample_rng)
    sample_z = torch.from_numpy(sample_z).to(dev)
    if sample_labels is not None:
        sample_labels = torch.from_numpy(sample_labels).to(dev)

    # the in-training FID samples the EMA generator on its device and
    # takes the features there too; it shares the grids' sampling cache
    fid_hook = None
    if is_main and loop_cfg.fid_every > 0:      # rank 0 alone scores
        if not hasattr(dataset, "at_resolution"):
            warnings.warn("in-training FID needs an array-backed dataset "
                          "with per-resolution caches; for folder/WikiArt "
                          "pipelines run pgx_torch.cli.fid_sweep post-hoc",
                          RuntimeWarning)
        else:
            from pgx_torch.eval.fid import make_extractor
            from pgx_torch.eval.inception import load_torch_weights
            from pgx_torch.eval.sweep import TrainingFid
            extractor = make_extractor(
                load_torch_weights(loop_cfg.inception_weights)
                if loop_cfg.inception_weights else None, device=dev)
            fid_hook = TrainingFid(dataset, gcfg,
                                   num_samples=loop_cfg.fid_samples,
                                   extractor=extractor, seed=loop_cfg.seed,
                                   gen_cache=gen_cache)

    prefetcher = None
    current_res = None
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    img_count = 0
    gp_count = 0
    cur_batch = loop_cfg.batch_size
    t_log = time.time()
    # per log tick: cumulative seconds since this run started and the
    # window's img/s; appends across resumes
    run_t0 = time.time()
    timing_path = os.path.join(trial_dir, "timing.json")
    timing: Dict[str, Any] = {}
    if is_main and os.path.exists(timing_path):
        try:
            with open(timing_path) as f:
                timing = json.load(f)
        except (OSError, ValueError):
            timing = {}

    auto_scan = loop_cfg.steps_per_call == 0
    scan_k = max(1, int(loop_cfg.steps_per_call))
    if scan_k > 1 and scan_k % tc.gp_every != 0:
        # _scan_window takes only gp_every-aligned windows; a misaligned k
        # would fall back to single steps for ever, so round it
        adj = max(tc.gp_every, round(scan_k / tc.gp_every) * tc.gp_every)
        print(f"steps_per_call={scan_k} is not a multiple of "
              f"gp_every={tc.gp_every}; using {adj}")
        scan_k = adj
    can_scan = ((scan_k > 1 or auto_scan) and tc.n_critic == 1
                and "on_iteration" not in hooks)
    stage_k: Dict[int, int] = {}    # auto: the window chosen per stage
    measure: list = []              # auto: single-step seconds

    interrupts = _Interrupts()
    try:
        i = start_iter
        while i < total:
            interrupts.check()
            st = schedule.state_at(i)
            if st.resolution != current_res:
                if prefetcher is not None:
                    prefetcher.close()
                cur_batch = stage_batch_for(st.step)
                prefetcher = DevicePrefetcher(
                    batch_fn(dataset, host_batch_for(cur_batch),
                             st.resolution, seed=host_seed + st.step), dev)
                current_res = st.resolution
                measure.clear()

            w = 1
            if can_scan and i != start_iter:   # the first iteration's events
                k_here = stage_k.get(st.step, 1) if auto_scan else scan_k
                if k_here > 1:
                    w = _scan_window(i, st, schedule, total, tc, loop_cfg,
                                     k_here)
            if w > 1:
                batches = [next(prefetcher) for _ in range(w)]
                # alphas as the f32 scalars pgx's loop hands its step
                alphas = [float(np.float32(schedule.state_at(i + j).alpha))
                          for j in range(w)]
                mkey = ("multi", st.step, st.fading, w)
                if mkey not in step_cache:
                    step_cache[mkey] = make_train_multi_step(
                        gcfg, dcfg, tc, step=st.step, fading=st.fading,
                        k=w, augment_cfg=augment_cfg, ada_cfg=ada_cfg,
                        augment_p=augment_p, process_group=group)
                i0 = i
                interrupts.in_step = True
                state, metrics = step_cache[mkey](
                    state, [b[0] for b in batches],
                    None if batches[0][1] is None
                    else [b[1] for b in batches], alphas,
                    draws=lambda j, real: draws(i0 + j, real))
                interrupts.in_step = False
                gp_count += w // tc.gp_every     # metrics are window sums
            else:
                imgs, labels = next(prefetcher)
                update_g = (i + 1) % tc.n_critic == 0
                apply_gp = i % tc.gp_every == 0
                fkey = (st.step, st.fading, update_g, apply_gp)
                if fkey not in step_cache:
                    step_cache[fkey] = make_train_step(
                        gcfg, dcfg, tc, step=st.step, fading=st.fading,
                        update_g=update_g, apply_gp=apply_gp,
                        augment_cfg=augment_cfg, ada_cfg=ada_cfg,
                        augment_p=augment_p, process_group=group)
                z, eps, aug_draws = draws(i, imgs)
                # alpha as the f32 scalar pgx's loop hands its step
                alpha = float(np.float32(st.alpha))
                t_meas = (time.perf_counter() if auto_scan and can_scan
                          and st.step not in stage_k else None)
                interrupts.in_step = True
                state, metrics = step_cache[fkey](
                    state, imgs, labels, alpha, z=z, eps=eps,
                    aug_draws=aug_draws)
                interrupts.in_step = False
                if t_meas is not None:
                    # a few single steps at the stage's start, each waited
                    # for; the first ones build (two step variants when
                    # gp_every > 1), the least of the rest is the step
                    float(metrics["d_total"])
                    measure.append(time.perf_counter() - t_meas)
                    if len(measure) >= 5:
                        ms = 1e3 * min(measure[2:])
                        # every rank must run the same windows: rank 0's
                        # measurement decides
                        ms = broadcast_obj(ms, group)
                        stage_k[st.step] = _auto_k(ms, tc.gp_every)
                        measure.clear()
                        if loop_cfg.verbose and is_main:
                            print(f"[auto] stage {st.step}: {ms:.1f} "
                                  f"ms/step -> steps_per_call "
                                  f"{stage_k[st.step]}", flush=True)
                # with gp_every > 1 the penalty is averaged over the
                # iterations that computed it
                gp_count += int(apply_gp)

            count += w
            img_count += w * cur_batch
            acc = {k: v.to(torch.promote_types(v.dtype, torch.float32))
                   for k, v in metrics.items()}
            sums = acc if not sums else {k: sums[k] + v
                                         for k, v in acc.items()}

            it = i + w
            if w > 1:
                # the events report the window's last iteration (the same
                # stage by construction; alpha has advanced)
                st = schedule.state_at(it - 1)
                alpha = alphas[-1]
            if is_main and (it % loop_cfg.sample_every == 0
                            or i == start_iter):
                gkey = (st.step, st.fading)
                if gkey not in gen_cache:
                    gen_cache[gkey] = make_eval_generate(
                        gcfg, step=st.step, fading=st.fading)
                images = gen_cache[gkey](state["g_ema"], sample_z,
                                         sample_labels, alpha)
                save_image_grid(
                    os.path.join(trial_dir, "sample",
                                 f"{str(it).zfill(3)}.png"),
                    images.float().cpu().numpy(), nrow=sample_nrow)

            if it % loop_cfg.checkpoint_every == 0 or i == start_iter:
                try:
                    save_full(it, state)
                except OSError:
                    pass  # a failed periodic write never ends the run

            if fid_hook is not None and it % loop_cfg.fid_every == 0:
                try:
                    fid = fid_hook.score(trial_dir, it, state["g_ema"], st)
                    if loop_cfg.verbose:
                        print(f"{it}; FID: {fid:.4f} "
                              f"(res {st.resolution})", flush=True)
                except Exception as e:   # a metric failure never ends a run
                    warnings.warn(f"in-training FID failed at {it}: {e}",
                                  RuntimeWarning)

            if is_main and it % loop_cfg.log_every == 0 and count:
                vals = {k: float(v) / count for k, v in sums.items()}
                if "grad_penalty" in sums:
                    vals["grad_penalty"] = (
                        float(sums["grad_penalty"]) / max(gp_count, 1))
                dt = time.time() - t_log
                ips = img_count / max(dt, 1e-9)
                msg = (f"{it}; G: {vals.get('g_loss', 0):.3f}; "
                       f"D: {vals.get('d_loss', 0):.3f}; "
                       f"Grad: {vals.get('grad_penalty', 0):.3f}; "
                       f"Alpha: {st.alpha:.3f}; "
                       + (f"AdaP: {vals.get('ada_p', 0):.3f}; "
                          if log_ada else "")
                       + f"res {st.resolution}; {ips:.1f} img/s")
                if loop_cfg.verbose:
                    print(msg, flush=True)
                with open(log_path, "a") as f:
                    f.write(f"{it},{vals.get('g_loss', 0):.5f},"
                            f"{vals.get('d_loss', 0):.5f},"
                            f"{vals.get('grad_penalty', 0):.5f},"
                            f"{st.alpha:.5f}"
                            + (f",{vals.get('ada_p', 0):.5f},"
                               f"{vals.get('ada_r', 0):.5f}"
                               if log_ada else "") + "\n")
                timing[str(it)] = {
                    "elapsed_s": round(time.time() - run_t0, 2),
                    "img_s": round(ips, 2),
                    "resolution": st.resolution}
                try:
                    with open(timing_path, "w") as f:
                        json.dump(timing, f, indent=1)
                except OSError:
                    pass   # timing is an artifact, never a failure
            if it % loop_cfg.log_every == 0 and count:
                sums, count, gp_count, t_log = {}, 0, 0, time.time()
                img_count = 0

            if "on_iteration" in hooks:
                hooks["on_iteration"](i, st, state, metrics)
            i += w
        interrupts.check()
    except (KeyboardInterrupt, SystemExit):
        # an interrupted run leaves a resumable checkpoint at the exact
        # iteration it stopped; the state is whole here (interrupts land
        # between steps)
        if is_main and not interrupts.in_step:
            it = int(state["iteration"])
            try:
                save_full(it, state)
                print(f"interrupted: emergency checkpoint saved at "
                      f"iteration {it} in {trial_dir}", flush=True)
            except Exception:  # best-effort: never mask the interrupt
                pass
        raise
    else:
        save_full(total, state)
    finally:
        interrupts.restore()
        if prefetcher is not None:
            prefetcher.close()
        if store is not None:
            store.close()       # drain the pending write

    if n_ranks > 1:
        torch.distributed.barrier(group)
    return trial_dir
